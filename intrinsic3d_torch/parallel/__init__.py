"""Multi-device refinement on `torch.distributed`.

Counterpart of `intrinsic3d_tpu/parallel/`. Where the JAX package runs one
`shard_map` program over a one-axis device mesh, the port runs one process
per rank, each holding its own brick of block rows on its own device, and
calls the collectives explicitly (`sharding.Mesh`): a `psum` is an
all-reduce, the halo `ppermute`s are one all-to-all per exchange
(`spmd.ShardedPlan`), and `staging.to_host_global` is an all-gather.
`dryrun` launches the ranks.
"""
