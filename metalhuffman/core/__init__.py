"""CPU codec core: canonical Huffman, bitstream, tables, delta, blocks.

NumPy reference implementations; the C++ library in
``metalhuffman.native`` mirrors these bit-for-bit as the fast host path.
"""

from . import bitstream, blocks, canonical, container, decode_ref, delta, encode, tables  # noqa: F401
from .container import EncodedStream  # noqa: F401
from .encode import encode_symbols  # noqa: F401
