"""Distribution over ``torch.distributed``: meshes, ring and Ulysses
attention, the pipeline (the JAX package's ``parallel`` exports).

One process (rank) a card, NCCL collectives outside the kernels; gloo on
the CPU. ``multihost.initialize_multihost`` starts the process group,
``mesh.create_mesh`` lays the ranks out on named axes, ``collectives``
holds the differentiable collectives the sharded trainer and engine use,
and ``telemetry`` counts the bytes each collective moves.
"""

from .mesh import AXIS_DATA, AXIS_MODEL, AXIS_SEQ, create_mesh
from .pipeline import make_pipeline
from .ring import make_ring_attention, ring_attention, softmax_merge
from .ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "AXIS_DATA",
    "AXIS_MODEL",
    "AXIS_SEQ",
    "create_mesh",
    "make_pipeline",
    "make_ring_attention",
    "make_ulysses_attention",
    "ring_attention",
    "softmax_merge",
    "ulysses_attention",
]
