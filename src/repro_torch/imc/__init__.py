"""In-memory compute (IMC): the bit-serial dot-product engine over packed
augmented storage and the array-level event/energy accounting.

  engine.BitSerialArray   resident packed weights, wordline-serial dot()
  energy.ImcEventLedger   host-side event/energy accumulator
  energy.*_events         analytic per-dispatch event counts

The kernels live in `repro_torch.kernels.imc_dot`; the model routing knob
is `cfg.amc.matmul_impl` ("dense" | "packed" | "imc").
"""
from repro_torch.imc.energy import (EVENT_ENERGY_FJ, ImcEventLedger,
                                    decode_matmul_events, imc_dot_events,
                                    kv_read_events, kv_write_events,
                                    matmul_events, refresh_events,
                                    weight_fetch_events)
from repro_torch.imc.engine import BitSerialArray

__all__ = [
    "EVENT_ENERGY_FJ", "ImcEventLedger", "BitSerialArray",
    "decode_matmul_events", "imc_dot_events", "kv_read_events",
    "kv_write_events", "matmul_events", "refresh_events",
    "weight_fetch_events",
]
