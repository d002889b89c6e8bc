"""The parallel layer over torch.distributed: the device mesh and the
tensor-parallel placement rules (`mesh`), the mixture-of-experts MLP with
expert parallelism (`moe`), GPipe pipeline parallelism (`pipeline`) and
ring-attention sequence parallelism (`sequence`)."""
