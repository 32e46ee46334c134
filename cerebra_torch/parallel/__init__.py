"""Parallelism over `torch.distributed` (port of cerebra/parallel): a mesh of
ranks with one process group per axis, the collectives the losses and
BatchNorm reduce with, the sharded corpora and their index streams, and the
DINO head's prototype sharding over a "model" axis.

A rank is one device. The invariant the port keeps is the one JAX's GSPMD
gives: a step over a world of W ranks computes what the JAX step computes on
a W-device mesh over the global batch. Every reduction over the batch is
global (the losses, BatchNorm's statistics, the DINO center), the gradient
is the gradient of that global loss (DDP's mean over the data group of each
rank's gradient of the global loss, which the collectives' backward makes W
times its share), and parameters stay replicated over the data group.
"""

from cerebra_torch.parallel.mesh import Mesh, make_mesh, shard_batch  # noqa: F401
from cerebra_torch.parallel import collectives  # noqa: F401
