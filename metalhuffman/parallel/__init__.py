"""Multi-device / multi-host codec: meshes, sharded decode, distributed init.

The reference is single-device (SURVEY.md section 2.6) — everything here is new
capability: the per-block bit-offset index already makes every block
independently decodable, so sharding is contiguous block ranges over a mesh
axis, with the code-word stream and decode tables replicated on every device
and the decoded spans gathered back in stream order.
"""

from . import mesh, multihost, shard_decode, shard_encode  # noqa: F401
from .mesh import make_mesh  # noqa: F401
from .shard_decode import decode_blocks_sharded  # noqa: F401
from .shard_encode import encode_symbols_sharded  # noqa: F401
