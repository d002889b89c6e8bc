"""The parallel layer over torch.distributed: the device mesh, the
tensor-parallel placement rules and the collectives (`mesh`), the
mixture-of-experts MLP with expert parallelism (`moe`), GPipe pipeline
parallelism (`pipeline`) and ring-attention sequence parallelism
(`sequence`).

Tensor parallelism of the captioner: cut the whole weights with
`mesh.shard_params(params, mesh)` on every rank of a ("data", "model")
mesh (`mesh.make_mesh`), then call `models.captioner.forward(local,
images, tokens, cfg, mesh)` (gathered logits) or
`train.captioner_train.train_step(state, *batch, cfg, mesh=mesh)` on
`mesh.shard_batch`'s block of the batch (the DP x TP step; the state
stays local). Launch one process a card: `torchrun --nproc-per-node N`,
each process joining with `mesh.initialize_distributed`."""
