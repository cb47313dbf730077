"""The distributed modes (counterpart of the JAX package's parallel/), on
``torch.distributed``: one process a rank, a ``DeviceMesh`` over the ranks
with the JAX package's axis names, the collectives ``all_reduce`` (SUM, MAX)
and ``all_gather``.

  * mesh.py: process groups, meshes, fleet sharding for both families
    (``solve_fleet``, ``solve_prox_fleet``);
  * consensus.py: one dense QP's rows split over the ranks
    (``solve_block_split``), and with a fleet on a 2-D mesh
    (``solve_fleet_block_split``);
  * prox_consensus.py: the same row split for the prox-ALM family;
  * sparse_mesh.py: one large sparse QP row-split, matrix-free PCG;
  * launch.py: spawn a world of ranks on one host and collect results;
  * dryrun.py: ``dryrun_multichip``, a dry run of every mode.

Every entry point is called on every rank with the whole problem and
returns the whole solution; each rank computes its own slice on its own
device (the card unless the mesh was made for the CPU).
"""
