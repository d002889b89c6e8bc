"""PyTorch/CUDA port of embodied_captioning_tpu's perception path.

Entry points: `perception.perceive` / `perception.Perceiver`, the weight
bridge in `params`, and the hand-written Hopper kernels in `kernels`.
Entry points run on the card ("cuda") unless the caller passes
device="cpu".
"""
