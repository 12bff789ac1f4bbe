"""Quantization constants (copied from ``areal_tpu/ops/quant_const.py``).

``KV_INT8_MAX`` is the int8 KV convention ``x ~= int8 * scale / 127.5``
shared by ``engine/paged.py`` (quantize / dequantize and the plain paged
attention) and the int8 paged-decode kernel (``csrc/paged_decode.cu``,
which writes the same value as a literal). The exact-max element clips
to 127 instead of wrapping at round(127.5) = 128.
"""

from __future__ import annotations

KV_INT8_MAX = 127.5
