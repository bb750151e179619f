"""Sharded runs on a mesh of processes over ``torch.distributed``: the
counterpart of ``cytvdn_tpu/parallel`` for scan-axis meshes."""

from cytvdn_tpu_torch.parallel.partition import choose_grid
from cytvdn_tpu_torch.parallel.distributed import init_distributed
from cytvdn_tpu_torch.parallel.halo import MeshComm
from cytvdn_tpu_torch.parallel.multihost import load_sharded_block, state_block
from cytvdn_tpu_torch.parallel.sharded import resolve_shard, run_sharded
from cytvdn_tpu_torch.parallel.api import denoise_sharded

__all__ = [
    "choose_grid",
    "init_distributed",
    "MeshComm",
    "load_sharded_block",
    "state_block",
    "resolve_shard",
    "run_sharded",
    "denoise_sharded",
]
