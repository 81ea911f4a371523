"""Bit-serial in-memory-compute (IMC) dot product over packed weights that
stay as stored: 2-bit ternary trits, int4 row pairs, int8, or the dual
buffer's two int4 planes.

Replaces `repro/kernels/imc_dot.py`: `imc_dot_pallas` (one resident
plane, three formats) and `imc_dual_dot_pallas` (one activation stream
over both planes of a dual buffer). CUDA source: `csrc/imc_dot.cu`.

The array semantics: activations are quantized per row to `abits` bits
(1, 4 or 8; `quantize_activations`) and streamed one magnitude bit-plane
per cycle; each plane {-1, 0, +1} is multiplied by the resident weights
and the partial sums are shift-added; the epilogue applies the
activation scale, then the per-channel weight scale. The plain versions
here spell that out (one float32 plane product per magnitude bit), as
the oracles `repro.kernels.ref.imc_dot_ref` / `imc_dual_dot_ref` do.

Every plane product and the shift-add are integers, so the bit-serial
sum IS the integer product xq @ W. The kernel takes it in int32 with
`__dp4a` (four int8 products a lane and instruction) and converts once:
it equals the plain version bit for bit wherever the plain float32
shift-add is exact, i.e. every partial sum stays under 2^24 — always for
ternary, for int4 and dual while K < 16.5k, for int8 while K <= 1040.
Past that (int8 at K = 2816) the plain version rounds and the kernel
does not. `mag_bits(abits)` is the cycle count the energy model bills;
the card does not loop over it.

What bounds it on an H100: at decode (M = batch) the packed weight
bytes, at prefill (M = batch x chunk) the multiply-adds. For M <= 16 a
call is ONE launch with the quantize fused in: the CTAs of a column
block split K, form one thread-block cluster and add their int32
partials through distributed shared memory; the split comes from (K, N)
alone and lives in the C source (`imc_decode_plan` reports it). Above
M = 16 a one-warp-per-row prepass quantizes the activations and 32 x 64
tiles unpack the weights once a K step into shared memory. Both routes
quantize bit-exactly as `quantize_activations` does (IEEE division,
round half to even) and leave the levels and scales they used in the
caller's scratch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import unpack_int4_hi, unpack_int4_lo
from repro_torch.core.ternary import unpack_ternary_2bit
from repro_torch.kernels.build import check, library

IMC_FORMATS = ("ternary", "dual", "int8", "int4")
FMT_CODES = {"ternary": 0, "int4": 1, "int8": 2}   # csrc constants
K_STEP, N_STEP = 64, 64          # shape granularity of the kernels (csrc)


def mag_bits(abits: int) -> int:
    """Bit-serial cycles per activation: the magnitude bits of a signed
    `abits`-bit value (the sign rides each plane, it is not a cycle)."""
    return 1 if abits == 1 else abits - 1


def qmax_for(abits: int) -> int:
    """Symmetric activation range [-qmax, qmax]; abits=1 is binary
    {-1, 0, +1}."""
    return 1 if abits == 1 else 2 ** (abits - 1) - 1


def k_pack(fmt: str) -> int:
    """K rows per stored byte-row of each format."""
    return {"ternary": 4, "int4": 2, "int8": 1, "dual": 1}[fmt]


def quantize_activations(x: torch.Tensor, abits: int):
    """Per-row symmetric quantization of the activations (the DAC in front
    of the wordline drivers): x (M, K) -> (xq int8 (M, K), xs (M, 1) f32)
    with x ~= xq * xs, xs = max(amax, 1e-8) / qmax and
    xq = clip(round_half_even(x / xs), -qmax, qmax)."""
    xf = x.float()
    q = qmax_for(abits)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # elementwise IEEE division: a CUDA tensor divided by a Python scalar
    # may be computed as a product with the scalar's reciprocal
    xs = amax.clamp_min(1e-8) / torch.full_like(amax, q)
    xq = torch.round(xf / xs).clamp(-q, q).to(torch.int8)
    return xq, xs


# ---------------------------------------------------------------------------
# the resident array contents, by format
# ---------------------------------------------------------------------------

def unpack_int4_rows(wp: torch.Tensor) -> torch.Tensor:
    """(K//2, N) uint8 -> (K, N) int8: two K-adjacent int4 rows per byte,
    the high nibble the even row."""
    hi, lo = unpack_int4_hi(wp), unpack_int4_lo(wp)
    return torch.stack([hi, lo], dim=1).reshape(wp.shape[0] * 2,
                                                wp.shape[1])


def unpack_weights(fmt: str, wp: torch.Tensor) -> torch.Tensor:
    """The (K, N) int8 weights a format's stored bytes hold."""
    if fmt == "ternary":
        return unpack_ternary_2bit(wp, wp.shape[0] * 4)
    if fmt == "int4":
        return unpack_int4_rows(wp)
    if fmt == "int8":
        return wp.view(torch.int8)
    raise ValueError(f"unknown IMC weight format {fmt!r} (ternary | int4 "
                     f"| int8; dual goes through imc_dual_dot)")


def _bit_serial(xq: torch.Tensor, w: torch.Tensor, abits: int):
    """sum_b 2^b (plane_b @ w), plane_b = sign(xq) * bit_b(|xq|) in
    {-1, 0, +1}: one float32 product per magnitude bit, shift-added."""
    xi = xq.to(torch.int32)
    sign, mag = torch.sign(xi), xi.abs()
    wf = w.float()
    acc = torch.zeros((xq.shape[0], w.shape[1]), dtype=torch.float32,
                      device=xq.device)
    for b in range(mag_bits(abits)):
        plane = (sign * ((mag >> b) & 1)).float()
        acc = acc + (2.0 ** b) * (plane @ wf)
    return acc


def imc_dot_plain(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
                  *, fmt: str, abits: int) -> torch.Tensor:
    """x (M, K) bf16, wp packed per `fmt` ((K//4, N) u8 trits, (K//2, N)
    u8 int4 row pairs or (K, N) i8), scale (1, N) f32 -> (M, N) bf16."""
    xq, xs = quantize_activations(x, abits)
    acc = _bit_serial(xq, unpack_weights(fmt, wp), abits)
    return (acc * xs * scale.float()).to(torch.bfloat16)


def imc_dual_dot_plain(x: torch.Tensor, buf: torch.Tensor,
                       hi_scale: torch.Tensor, lo_scale: torch.Tensor, *,
                       abits: int):
    """One activation stream over both int4 planes of buf (K, N) uint8:
    (y_hi, y_lo) (M, N) bf16."""
    xq, xs = quantize_activations(x, abits)
    acc_hi = _bit_serial(xq, unpack_int4_hi(buf), abits)
    acc_lo = _bit_serial(xq, unpack_int4_lo(buf), abits)
    return ((acc_hi * xs * hi_scale.float()).to(torch.bfloat16),
            (acc_lo * xs * lo_scale.float()).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_abits(abits: int) -> None:
    if abits not in (1, 4, 8):
        raise ValueError(f"abits must be 1, 4 or 8, got {abits}")


def quantize_activations_cuda(x: torch.Tensor, abits: int):
    """The kernel's quantize pre-pass alone; same contract as
    `quantize_activations` on a (M, K) bf16 CUDA tensor."""
    if not x.is_cuda:
        raise ValueError("quantize_activations_cuda takes CUDA tensors")
    if x.dtype != torch.bfloat16 or x.ndim != 2:
        raise TypeError(f"want (M, K) bf16, got {tuple(x.shape)} {x.dtype}")
    _check_abits(abits)
    M, K = x.shape
    if K % 8:
        raise ValueError(f"K = {K}: the quantize pass needs K % 8 == 0")
    x = _aligned(x)                # the pass reads activations as vectors
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M:
        err = library().imc_quantize(
            x.data_ptr(), xq.data_ptr(), xs.data_ptr(), M, K, qmax_for(abits),
            torch.cuda.current_stream(x.device).cuda_stream)
        check(err, "imc_quantize")
    return xq, xs


def _launch(name: str, x, w, scales, outs: int, k_rows: int, abits: int,
            fmt_code=()):
    """Check the operands, allocate the outputs and the scratch, and call
    the C entry `name` once: (outputs, levels, scales) where the levels
    (M, K) int8 and scales (M, 1) f32 are what the call quantized x to.
    The route and the K split are the C source's choice."""
    _check_abits(abits)
    M, K = x.shape
    Kp, N = w.shape
    if x.dtype != torch.bfloat16 or w.dtype not in (torch.uint8, torch.int8) \
            or any(s.dtype != torch.float32 for s in scales):
        raise TypeError(f"want bf16 x, uint8/int8 weights, f32 scales; got "
                        f"{x.dtype}, {w.dtype}, "
                        f"{[s.dtype for s in scales]}")
    if Kp * k_rows != K or K % K_STEP or N % N_STEP \
            or any(s.numel() != N for s in scales):
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: need K == {k_rows} * "
                         f"w.shape[0], K % {K_STEP} == 0, N % {N_STEP} == 0"
                         f", one scale a column")
    # x, w and the scales are read as 16-byte vectors
    x, w, scales = _aligned(x), _aligned(w), [_aligned(s) for s in scales]
    ys = [torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
          for _ in range(outs)]
    # the levels (M * K int8), then the scales (M f32)
    scratch = torch.empty(M * K + 4 * M, dtype=torch.uint8, device=x.device)
    xq = scratch[:M * K].view(torch.int8).view(M, K)
    xs = scratch[M * K:].view(torch.float32).view(M, 1)
    if M:
        err = getattr(library(), name)(
            x.data_ptr(), scratch.data_ptr(), w.data_ptr(),
            *(s.data_ptr() for s in scales), *(y.data_ptr() for y in ys),
            M, K, N, *fmt_code, qmax_for(abits),
            torch.cuda.current_stream(x.device).cuda_stream)
        check(err, name)
    return ys, xq, xs


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _require_cuda(name: str, *ts) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} takes CUDA tensors")


def imc_dot_levels(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
                   *, fmt: str, abits: int):
    """The kernel's call on CUDA tensors: (y, xq, xs), y as `imc_dot_plain`
    gives it, and the levels and scales the call used."""
    _require_cuda("imc_dot_cuda", x, wp, scale)
    if fmt not in FMT_CODES:
        raise ValueError(f"unknown IMC weight format {fmt!r}")
    (y,), xq, xs = _launch("imc_dot", x, wp, (scale,), 1, k_pack(fmt), abits,
                           (FMT_CODES[fmt],))
    if x.shape[0]:
        imc_dot_cuda.launches += 1
    return y, xq, xs


def imc_dot_cuda(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor, *,
                 fmt: str, abits: int) -> torch.Tensor:
    """The bit-serial dot kernel (one launch at M <= 16); same contract as
    `imc_dot_plain`."""
    return imc_dot_levels(x, wp, scale, fmt=fmt, abits=abits)[0]


def imc_dual_dot_levels(x: torch.Tensor, buf: torch.Tensor,
                        hi_scale: torch.Tensor, lo_scale: torch.Tensor, *,
                        abits: int):
    """As `imc_dot_levels` for the dual buffer: ((y_hi, y_lo), xq, xs)."""
    _require_cuda("imc_dual_dot_cuda", x, buf, hi_scale, lo_scale)
    ys, xq, xs = _launch("imc_dual_dot", x, buf, (hi_scale, lo_scale), 2, 1,
                         abits)
    if x.shape[0]:
        imc_dual_dot_cuda.launches += 1
    return tuple(ys), xq, xs


def imc_dual_dot_cuda(x: torch.Tensor, buf: torch.Tensor,
                      hi_scale: torch.Tensor, lo_scale: torch.Tensor, *,
                      abits: int):
    """The dual-plane dot kernel (each byte read once, two accumulators);
    same contract as `imc_dual_dot_plain`."""
    return imc_dual_dot_levels(x, buf, hi_scale, lo_scale, abits=abits)[0]


def decode_plan(K: int, N: int) -> tuple[int, int]:
    """The C source's plan for the M <= 16 route at (K, N): (columns a
    CTA, CTAs splitting K). Asks the built library."""
    plan = (ctypes.c_int * 2)()
    check(library().imc_decode_plan(K, N, ctypes.addressof(plan)),
          "imc_decode_plan")
    return plan[0], plan[1]


imc_dot_cuda.launches = 0
imc_dual_dot_cuda.launches = 0
