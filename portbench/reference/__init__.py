"""The benchmark's plain reference: what the program's outputs are judged by.

Written from the stripe format's definition, in NumPy and plain PyTorch,
with no import of the program (``tpu3fs_torch``), of ``tpu3fs`` or of JAX:

- ``rs``: RS(k, m) over GF(2^8) (polynomial 0x11D), generator [I_k ; C],
  C the Cauchy matrix 1 / (i ^ (m + j)) with its columns scaled so that
  parity row 0 is all ones; encode and erasure decode.
- ``crc32c``: CRC32C (Castagnoli, reflected, init and final XOR
  0xFFFFFFFF) of many rows at once, by blocks combined in a tree.
- ``payload``: the byte pool and the per-call stamps of the file traffic.
"""
