"""Carry codec state across from the JAX package as numpy arrays.

``codec_from_arrays`` builds the port's codec from the arrays a JAX
``RSCode``/``BatchCrc32c`` holds, so the two can be shown to compute the same
function from the same state. The caller reads the arrays; this module never
imports ``tpu3fs``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tpu3fs_torch.ops.crc32c import BatchCrc32c
from tpu3fs_torch.ops.rs import RSCode
from tpu3fs_torch.ops.stripe import StripeCodec


def codec_from_arrays(arrays: Dict[str, np.ndarray], device=None) -> StripeCodec:
    """Build a StripeCodec from

    - ``parity_matrix`` (m, k) uint8 and ``parity_bits`` (8m, 8k) int8
      (``RSCode.parity_matrix`` and ``RSCode._parity_bits``);
    - ``crc_b_t`` (8*block, 32) int8, ``crc_ks`` (N, 32, 32) int8 and
      ``crc_const`` uint32 (``BatchCrc32c._b_t``, ``._ks``, ``._const``).

    The shard size is N * block. Its ``.rs`` and ``._crc`` are the port's
    RSCode and BatchCrc32c."""
    rs = RSCode.from_arrays(arrays["parity_matrix"], arrays["parity_bits"],
                            device=device)
    crc = BatchCrc32c.from_arrays(arrays["crc_b_t"], arrays["crc_ks"],
                                  arrays["crc_const"], device=device)
    return StripeCodec.from_parts(rs, crc)
