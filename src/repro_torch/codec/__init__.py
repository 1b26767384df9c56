"""Entropy-coding subsystem: context-adaptive interleaved rANS (host numpy).

Copy of ``repro.codec`` for the port; the wire bytes are the same.

  * ``rans.py``      — interleaved multi-stream rANS core
  * ``context.py``   — adaptive quantized-up-neighbor/channel context model
  * ``container.py`` — the RTC1 container: per-tile chunks, partial decode
  * ``backend.py``   — tensor-level adapters registered with core/codec.py
  * ``batch.py``     — cross-container batched decode

Symbol statistics for static tables come from the histogram kernel
(repro_torch.kernels.histogram) on the card, or its plain version on the
host.
"""
from repro_torch.codec.backend import (decode_channels, decode_tensor,
                                       encode_adaptive_tensor,
                                       encode_static_tensor)
from repro_torch.codec.batch import decode_tensor_batch
from repro_torch.codec.container import RansContainer
from repro_torch.codec.context import decode_ctx, encode_ctx, plan_lanes
from repro_torch.codec.rans import (CorruptStream, RansTable, normalize_freqs,
                                    rans_decode, rans_encode)

__all__ = [
    "CorruptStream", "RansContainer", "RansTable",
    "decode_channels", "decode_ctx", "decode_tensor", "decode_tensor_batch",
    "encode_adaptive_tensor", "encode_ctx", "encode_static_tensor",
    "normalize_freqs", "plan_lanes", "rans_decode", "rans_encode",
]
