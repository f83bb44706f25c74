"""Device compute paths: the decode kernel, XLA decode/encode, layout."""

from . import decode_pallas, decode_xla, encode_device, encode_xla, layout  # noqa: F401
