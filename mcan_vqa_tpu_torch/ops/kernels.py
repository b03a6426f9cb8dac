"""Wrappers of the hand-written CUDA kernels (csrc/*.cu) that the serving
blocks (ops/sga_block.py, ops/quant.py) and the train blocks
(ops/sga_train.py, ops/sa_train.py) are built from, each beside its plain
PyTorch version.

  gemm_bias_act          C = A . W + bias (ReLU, dropout)      gemm_sm90.cu, NN
  gemm_dx                C = dY . W^T (gradient gate, + res)   gemm_sm90.cu, NT
  gemm_dw                C = X^T . dY (split-K, fixed order)   gemm_sm90.cu, TN
  gemm_ln                LN(res + A . W + bias)                gemm_ln.cu
  gemm_s8                dequant(int8 A . int8 W) + bias (ReLU) gemm_sm90.cu, S8
  gemm_s4                grouped dequant(int8 A . int4 W) + bias gemm_int4.cu, S4
  gemm_w4bf16            A . bf16(int4 W x group scale) + bias  gemm_int4.cu, W4
  quantize_rows          int8 codes of rows, dynamic or static  quantize.cu
  masked_attention       softmax(q k^T / 8, PAD) (dropout) . v, bf16 or f32
  masked_attention_bwd   dq, dk, dv of the above
  residual_layernorm     LN(res + drop(y + bias)), optionally r
  residual_layernorm_bwd dr, drop(dr), g * u of that LN
  col_sum                column sums (bias and LN gradients)
  attflat_pool           AttFlat's logits, softmax over L, pooling
                                                               attflat_pool.cu
  sga_decoder            every SGA layer in one cooperative launch
                                                               sga_decoder.cu
  sa_encoder             every SA layer in one cooperative launch
                                                               sa_encoder.cu
  ffn_ln_blocked         LN(x + relu(x . W1 + b1) . W2 + b2), M outer
                                                               ffn_ln_blocked.cu
  ffn_ln_wstationary     the same, F outer, weights stationary
                                                           ffn_ln_wstationary.cu
  dump_prng_masks        the keep-masks of seeded sites        prng_masks.cu
  philox_words           the Philox4x32-10 words behind them   prng_masks.cu

Dispatch is on the device of the tensors: on a CPU tensor a wrapper runs
its plain version; on a CUDA tensor it launches its kernel, or raises if
the kernel does not take the arguments. There is no fallback from one to
the other.

While ``torch.export`` traces (``exporting()``), the serving wrappers
(gemm_bias_act, gemm_ln, quantize_rows, gemm_s8, gemm_s4, gemm_w4bf16,
masked_attention, residual_layernorm, attflat_pool) call their
``torch.ops.mcan.*`` op instead (ops/library.py), whose implementation is
the wrapper itself; the live engines never do.

Each launch adds one to ``LAUNCHES[<wrapper name>]`` (the f32-output
attention to ``LAUNCHES["masked_attention_f32"]``), and nothing else does,
so a run can show that its main path went through the kernels
(``reset_launches`` / ``launch_counts``).

Dropout keep-masks are uint8 (or bool) tensors of 0 / 1 laid out like the
values they gate; kept values are scaled by ``inv_keep`` in f32, as the
TPU kernels' ``_drop`` does (mcan_vqa_tpu/ops/sga_train.py:145). Where a
wrapper takes ``mask`` (``drop`` for the attention), it also takes a
``Philox`` in its place: the seeded keep source of the train kernels'
in-kernel dropout (the ``_prng`` kernels of sga_train.py / sa_train.py),
which the kernel draws element by element and never reads from memory. The
plain versions draw the same bits with ``philox4x32_plain``.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from mcan_vqa_tpu_torch.models.attention import NEG_INF
from mcan_vqa_tpu_torch.models.attention import masked_attention as \
    _attention_f32
from mcan_vqa_tpu_torch.models.attention import split_heads
from mcan_vqa_tpu_torch.models.layers import BF16, bf16_matmul, \
    std_layer_norm

F32 = torch.float32
I8 = torch.int8
LN_EPS = 1e-6
MAX_HEAD_DIM = 256     # the attention kernels' Dh: any width up to this
ONE_BLOCK_ATTENTION = 128  # the forward's one-block kernel: Dh and Lk up
#                            to this (any Lq); the backward's: Dh, Lq and Lk;
#                            past it the long kernels (any Lq, Lk)
GEMM_ALIGN = 8         # the GEMMs' N and K: whole 16-byte chunks of bf16
LN_MAX_WIDTH = 2048    # the LayerNorm kernels' D: a multiple of 32 up to this
ATTFLAT_MAX_LOGITS = 12288  # attflat_pool's L x G: logits and weights in 96 KB
MAX_COL_SUMS = 4
MASK_DTYPES = (torch.uint8, torch.bool)

LAUNCHES: Dict[str, int] = collections.Counter()

_NT, _TN, _NN, _S8 = 1, 2, 3, 4   # gemm_sm90.cu's layouts (S8: mcan_gemm_sm90_s8)
_S4, _W4 = 5, 6   # gemm_int4.cu's: mcan_gemm_s4, mcan_gemm_w4bf16
# gemm_int4.cu's instances: (layout, activation rows a tile) -> the slots
# of its ring; 128 weight columns a tile
INT4_STAGES = {(_S4, 64): 6, (_W4, 64): 8, (_W4, 128): 7}
INT4_INSTANCES = tuple(INT4_STAGES)


def reset_launches() -> None:
    LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def exporting() -> bool:
    """True while ``torch.export`` traces a forward: the serving wrappers
    then turn to their ``torch.ops.mcan.*`` ops (ops/library.py), whose
    implementation is the wrapper again, and the blocks take their kernel
    route on either device."""
    return torch.compiler.is_exporting()


def _ops():
    from mcan_vqa_tpu_torch.ops import library
    return library


def kernel_route(t: torch.Tensor) -> bool:
    """Whether a block function runs its kernels' wrappers (on a CUDA
    tensor, and while exporting on either device) or its plain version."""
    return exporting() or on_cuda(t)


def count_block(name: str) -> None:
    """One launch of a block function, counted where the block runs live:
    a trace runs it once, whatever the exported program runs later."""
    if not exporting():
        LAUNCHES[name] += 1


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device (there is no plain version for it and no kernel)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cuda or cpu")


def _lib():
    from mcan_vqa_tpu_torch.ops._build import load_library
    return load_library()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _same_device(name: str, *ts: Optional[torch.Tensor]) -> None:
    dev = next(t.device for t in ts if t is not None)
    _require(all(t is None or t.device == dev for t in ts),
             f"{name}: all tensors must be on {dev}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _f32(x: float) -> float:
    """A Python float rounded to the nearest f32 value: how a JAX kernel
    holds a Python constant (a weakly typed scalar) against f32 arrays.
    Host-only (struct), so it adds no tensor to a launch."""
    return struct.unpack("f", struct.pack("f", x))[0]


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, one correctly rounded division per element on either device
    (on CUDA, PyTorch divides by a Python scalar as a multiplication by its
    reciprocal, which can land an ulp away)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# in-kernel dropout: the Philox4x32-10 keep source
# ---------------------------------------------------------------------------

PHILOX_M = (0xD2511F53, 0xCD9E8D57)    # Random123's round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)    # and key increments
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Philox:
    """The seeded keep-mask of one dropout site (csrc/common.cuh): keep iff
    word e & 3 of Philox4x32-10 with key (seed, site) at counter (e >> 2,
    b, 0, 0) is below thresh, for element e of sample b's slab. rows: the
    rows per sample of a [B * rows, N] operand (e = r * N + c); the
    attention kernels key head h by site + h (e = i * Lk + j) and ignore
    rows."""
    seed: int
    site: int
    thresh: int
    rows: int = 0


Keep = Union[torch.Tensor, Philox, None]


def _mulhilo32(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * m for int64 a in [0, 2^32) and a
    32-bit constant m. Torch has no uint64 product and a * m may pass
    2^63, so a is cut into 16-bit limbs: each limb times m stays below
    2^48, exact in int64."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_plain(ctr: torch.Tensor, key: Sequence[int]) -> torch.Tensor:
    """Philox4x32-10 of int64 counters [..., 4] (each word in [0, 2^32))
    under the key (k0, k1) -> int64 words [..., 4] (Random123's
    philox4x32_R(10, ...))."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = int(key[0]), int(key[1])
    for _ in range(10):
        hi0, lo0 = _mulhilo32(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & _U32, (k1 + PHILOX_W[1]) & _U32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_words_plain(seed: int, site: int, B: int, n: int,
                       device="cpu") -> torch.Tensor:
    """int64 [B, n]: element e of sample b takes word e & 3 of the counter
    (e >> 2, b, 0, 0) under the key (seed, site)."""
    n4 = -(-n // 4)
    c = torch.arange(n4, dtype=torch.int64, device=device)
    b = torch.arange(B, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    ctr = torch.stack(torch.broadcast_tensors(c[None, :], b[:, None], zero,
                                              zero), dim=-1)
    return philox4x32_plain(ctr, (seed, site)).reshape(B, 4 * n4)[:, :n]


def philox_words(seed: int, site: int, B: int, n: int, device="cuda",
                 raw: bool = False) -> torch.Tensor:
    """``philox_words_plain`` on the card: int64 [B, n] of the uint32
    words the kernels draw, in one launch of csrc/prng_masks.cu
    (``prng_plan`` of the one site, 4-byte elements, a counter a chunk);
    any B and n. raw: the uint32 [B, n] as the kernel writes it (no int64
    copy)."""
    if torch.device(device).type != "cuda":
        words = philox_words_plain(seed, site, B, n, device)
        return words.to(torch.uint32) if raw else words
    name = "philox_words"
    out = torch.empty((B, n), dtype=torch.uint32, device=device)
    if B * n > 0:
        plan = prng_plan(B, ((1, n),), GEMM_SMS, 4)
        _prng_launch(name, _lib().mcan_philox_words, plan, out.device, seed,
                     site, B, n, out.data_ptr())
    return out if raw else out.to(torch.int64)


def dump_prng_masks_plain(seed: int, thresh: int, B: int,
                          sites: Sequence[Tuple[int, int, int]],
                          device="cpu") -> List[torch.Tensor]:
    """One uint8 keep-mask [B, heads, n] per (site, heads, n): head h of
    sample b keyed (seed, site + h), kept where its word < thresh."""
    return [torch.stack([philox_words_plain(seed, site + h, B, n, device)
                         < thresh for h in range(heads)], dim=1)
            .to(torch.uint8).reshape(B, heads, n) for site, heads, n in sites]


def dump_prng_masks(seed: int, thresh: int, B: int,
                    sites: Sequence[Tuple[int, int, int]],
                    device="cuda") -> List[torch.Tensor]:
    """The keep-masks the seeded kernels draw for up to six sites of one
    block, in one launch of csrc/prng_masks.cu (``prng_plan``): uint8 [B,
    heads, n] per (site, heads, n), as ``dump_prng_masks_plain`` computes
    them (mcan_vqa_tpu/ops/sga_train.py::dump_prng_masks, :1581); any B,
    heads and n. ``LAST_GRID["dump_prng_masks"]`` holds the last launch's
    (grid, CTAs an SM, SMs, 0)."""
    if torch.device(device).type != "cuda":
        return dump_prng_masks_plain(seed, thresh, B, sites, device)
    name = "dump_prng_masks"
    k = len(sites)
    _require(1 <= k <= PRNG_MAX_SITES,
             f"{name}: 1 to {PRNG_MAX_SITES} sites, got {k}")
    outs = [torch.empty((B, heads, n), dtype=torch.uint8, device=device)
            for _, heads, n in sites]
    if B * sum(h * n for _, h, n in sites) == 0:
        return outs
    dev = outs[0].device
    plan = prng_plan(B, tuple((h, n) for _, h, n in sites), GEMM_SMS)
    arrays = ((ctypes.c_void_p * k)(*[t.data_ptr() for t in outs]),
              (ctypes.c_uint * k)(*[s for s, _, _ in sites]),
              (ctypes.c_int * k)(*[h for _, h, _ in sites]),
              (ctypes.c_int * k)(*[n for _, _, n in sites]))
    _prng_launch(name, _lib().mcan_prng_masks, plan, dev, k,
                 *(ctypes.cast(a, ctypes.c_void_p) for a in arrays), B, seed,
                 thresh)
    return outs


# ---------------------------------------------------------------------------
# the plan of prng_masks.cu (the mask dump and the raw words)
# ---------------------------------------------------------------------------

PRNG_THREADS = 256        # prng_masks.cu: threads a CTA
PRNG_BLOCKS_PER_SM = 4    # its __launch_bounds__ minimum: the wave's CTAs
#                           an SM
PRNG_CHUNK_BYTES = 16     # what a thread draws at once: 4 counters' keep
#                           bytes, or one counter's 4 words
PRNG_MAX_SITES = 6


def _magic(d: int) -> Tuple[int, int, int]:
    """(m, s1, s2) for which ``_fast_div(q, m, s1, s2) == q // d`` at every
    32-bit q, for 1 <= d < 2^32 (Granlund and Montgomery's round-up method,
    as libdivide writes it branch-free; prng_masks.cu's fast_div); (0, 0,
    0) for d = 0, which divides nothing."""
    if d == 0:
        return 0, 0, 0
    ceil_log2 = (d - 1).bit_length()
    return (((1 << 32) * ((1 << ceil_log2) - d)) // d + 1,
            min(ceil_log2, 1), max(ceil_log2 - 1, 0))


def _fast_div(q: int, m: int, s1: int, s2: int) -> int:
    t = (q * m) >> 32
    return (t + ((q - t) >> s1)) >> s2


@dataclass(frozen=True)
class PrngPlan:
    """How prng_masks.cu covers one call (``prng_plan``): chunks of
    ``chunk`` elements (16 bytes) of a row; a sample's chunks site
    after site from ``first[s]`` (``per_row[s]`` a row: row h of site s
    from ``first[s] + h per_row[s]``), the samples end to end; ``grid``
    CTAs of ``threads`` threads stride over them, thread t from chunk t.
    ``width[s]``: the bytes of one store into site s."""
    B: int
    sites: Tuple[Tuple[int, int], ...]    # (heads, n) a site
    elem_bytes: int                       # 1: keep bytes; 4: words
    first: Tuple[int, ...]
    per_row: Tuple[int, ...]
    width: Tuple[int, ...]
    per_sample: int
    grid: int
    threads: int

    @property
    def chunk(self) -> int:
        """Elements a chunk: 16 keep bytes (4 counters) or 4 words (1)."""
        return PRNG_CHUNK_BYTES // self.elem_bytes

    @property
    def chunks(self) -> int:
        return self.B * self.per_sample

    @property
    def step(self) -> Tuple[int, int]:
        """The grid's stride as (samples, chunks)."""
        return divmod(self.grid * self.threads, self.per_sample)

    @property
    def counters(self) -> int:
        """The Philox counters the call needs: ceil(n / 4) a row."""
        return self.B * sum(h * -(-n // 4) for h, n in self.sites)

    @property
    def out_bytes(self) -> int:
        return self.B * sum(h * n for h, n in self.sites) * self.elem_bytes

    def fields(self) -> Tuple[int, ...]:
        """What the C entries take (unsigned 32-bit): n_sites, B,
        per_sample, grid, threads, step_b, step_j, then per site first,
        per_row, the magic number of the division by per_row (m, s1, s2)
        and width."""
        out = [len(self.sites), self.B, self.per_sample, self.grid,
               self.threads, *self.step]
        for first, per_row, width in zip(self.first, self.per_row,
                                         self.width):
            out += [first, per_row, *_magic(per_row), width]
        return tuple(out)

    def locate(self, j: int) -> Tuple[int, int, int]:
        """Chunk j of a sample -> (site, head, chunk of the row), as the
        kernel finds them: the count of the later sites' prefixes at or
        below j, then the magic division."""
        s = sum(j >= f for f in self.first[1:])
        q = j - self.first[s]
        h = _fast_div(q, *_magic(self.per_row[s]))
        return s, h, q - h * self.per_row[s]

    def walk(self, t: int):
        """The chunks thread t draws, in order, as (sample, chunk of the
        sample): the kernel's loop with its one division and its carries."""
        b, j = divmod(t, self.per_sample)
        step_b, step_j = self.step
        wrap = self.per_sample - step_j
        while b < self.B:
            yield b, j
            if j >= wrap:
                j, b = j - wrap, b + step_b + 1
            else:
                j, b = j + step_j, b + step_b


@functools.lru_cache(maxsize=1024)
def prng_plan(B: int, sites: Tuple[Tuple[int, int], ...], sms: int,
              elem_bytes: int = 1) -> PrngPlan:
    """The plan of one prng_masks.cu launch from the shapes and the SM
    count alone. ``sites``: 1 to 6 (heads, n) pairs, rows of n elements of
    ``elem_bytes`` (1: the keep masks; 4: philox_words' one site), cut into
    chunks of 16 bytes (the last of a row shorter). Each
    site's store width is the widest of 16, 8, 4, 2 and 1 bytes that
    divides its rows; the grid one wave of ``PRNG_BLOCKS_PER_SM`` CTAs an
    SM, fewer where the chunks do not fill it (no CTA without a chunk).
    The kernel keeps a sample's chunk index in 32 bits: a sample's chunks
    must number under 2^32 (64 GiB of keep bytes a sample), and B under
    2^31."""
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    _require(1 <= len(sites) <= PRNG_MAX_SITES,
             f"prng_plan: 1 to {PRNG_MAX_SITES} sites, got {len(sites)}")
    _require(1 <= B < 1 << 31 and sms >= 1 and elem_bytes in (1, 4)
             and all(h >= 0 and 0 <= n < 1 << 31 for h, n in sites),
             f"prng_plan: B={B}, sites {sites}, {sms} SMs, {elem_bytes}-byte "
             f"elements")
    per_row = tuple(cdiv(n, PRNG_CHUNK_BYTES // elem_bytes) for _, n in sites)
    first, at = [], 0
    for (heads, _), r in zip(sites, per_row):
        first.append(at)
        at += heads * r
    _require(1 <= at < 1 << 32,
             f"prng_plan: a sample's chunks must number 1 to 2^32 - 1, got "
             f"{at} (sites {sites})")
    width = tuple(next(w for w in (16, 8, 4, 2, 1) if n * elem_bytes % w == 0)
                  for _, n in sites)
    grid = min(cdiv(B * at, PRNG_THREADS), sms * PRNG_BLOCKS_PER_SM)
    return PrngPlan(B, tuple(sites), elem_bytes, tuple(first), per_row,
                    width, at, grid, PRNG_THREADS)


def _prng_launch(name: str, fn, plan: PrngPlan, device: torch.device,
                 *args) -> None:
    """One launch of a prng_masks.cu entry: its arguments, then the plan's
    fields, their count and the stream; ``LAST_GRID[name]`` = (grid, CTAs
    an SM, SMs, 0)."""
    fields = plan.fields()
    rc = fn(*args, (ctypes.c_uint * len(fields))(*fields), len(fields),
            torch.cuda.current_stream(device).cuda_stream)
    LAST_GRID[name] = (plan.grid, PRNG_BLOCKS_PER_SM, GEMM_SMS, 0)
    _check(rc, name)


def _rows_keep(p: Philox, M: int, N: int, device) -> torch.Tensor:
    """The bool keep-mask [M, N] of a [B * p.rows, N] operand."""
    return (philox_words_plain(p.seed, p.site, M // p.rows, p.rows * N,
                               device) < p.thresh).reshape(M, N)


def _heads_keep(p: Philox, B: int, H: int, Lq: int, Lk: int,
                device) -> torch.Tensor:
    """The bool keep-mask [B, H, Lq, Lk] of an attention map."""
    return dump_prng_masks_plain(p.seed, p.thresh, B, [(p.site, H, Lq * Lk)],
                                 device)[0].bool().reshape(B, H, Lq, Lk)


def _keep_args(name: str, mask: Keep, M: Optional[int] = None):
    """-> (the mask tensor or None, the C arguments of the keep source: on,
    seed, site, thresh and, for a rows operand of M rows, rows)."""
    if not isinstance(mask, Philox):
        return mask, (0, 0, 0, 0) + ((0,) if M is not None else ())
    _require(0 <= mask.seed <= _U32 and 0 <= mask.site <= _U32
             and 1 <= mask.thresh <= _U32,
             f"{name}: Philox seed, site and thresh must be 32-bit words")
    if M is None:
        return None, (1, mask.seed, mask.site, mask.thresh)
    _require(mask.rows > 0 and M % mask.rows == 0,
             f"{name}: {M} rows do not split into samples of {mask.rows}")
    return None, (1, mask.seed, mask.site, mask.thresh, mask.rows)


def _drop(x: torch.Tensor, mask: Optional[torch.Tensor],
          inv_keep: float) -> torch.Tensor:
    """Inverted dropout with an external keep-mask (plain versions)."""
    if mask is None:
        return x
    return torch.where(mask.bool(), x * inv_keep, torch.zeros_like(x))


def _check_mask(name: str, mask: Optional[torch.Tensor], shape) -> None:
    if mask is not None:
        _require(mask.dtype in MASK_DTYPES and tuple(mask.shape)
                 == tuple(shape) and mask.is_contiguous(),
                 f"{name}: dropout mask must be a contiguous uint8 / bool "
                 f"tensor shaped {tuple(shape)}")


def _check_vec(name: str, t: Optional[torch.Tensor], n: int) -> None:
    _require(t is None or (t.dtype == F32 and t.is_contiguous()
                           and t.numel() == n),
             f"{name}: bias / LN parameters must be f32 [{n}]")


def _check_rows(name: str, t: Optional[torch.Tensor], shape, dtypes) -> None:
    """A 2-D operand read or written row by row: the given shape and dtype,
    unit column stride."""
    if t is not None:
        _require(tuple(t.shape) == tuple(shape) and t.dtype in dtypes
                 and t.stride(1) == 1,
                 f"{name}: expected {tuple(shape)} {dtypes} with unit "
                 f"column stride, got {tuple(t.shape)} {t.dtype}")


# ---------------------------------------------------------------------------
# the GEMMs on gemm_sm90.cu: gemm_bias_act (NN), gemm_dx (NT), gemm_dw
# (TN) and gemm_s8 (S8); the plan of gemm_int4.cu's too (S4, W4)
# ---------------------------------------------------------------------------

GEMM_SMS = 132         # an H100 SXM's SMs: a constant, so that a shape
#                        always gets the same plan (and dW the same bits)
GEMM_BM, GEMM_BK = 128, 64   # gemm_sm90.cu's tile height and K-tile
GEMM_BK_S8 = 128       # the int8 K-tile: 128 bytes a row, as bf16's 64
# the int4 products' K-tiles a split holds at the least (S4: groups), and
# their splits at the most: the card ran B=1 S4 slower at 2 groups a split,
# W4 faster at 2 K-tiles than at 4
INT4_SPLIT_MIN_TILES = {_S4: 4, _W4: 2}
INT4_MAX_SPLITS = 8


@dataclass(frozen=True)
class GemmPlan:
    """How gemm_sm90.cu (or gemm_int4.cu) covers one product: output
    tiles of ``bm`` x ``bn``, the reduction in ``k_tiles`` K-tiles of
    ``bk`` elements (128 bytes a row of A in every layout) split over
    ``splits`` blocks per tile; split s sums K-tiles ``split_range(s)``.
    ``term_slots`` (S4): the workspace holds split 0's partial and then
    each later K-tile's term on its own, not one partial per split."""
    bm: int
    bn: int
    bk: int
    tiles_m: int
    tiles_n: int
    k_tiles: int
    splits: int
    term_slots: bool = False

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def blocks(self) -> int:
        """Work items: one split of one tile each."""
        return self.tiles * self.splits

    @property
    def grid(self) -> int:
        """Persistent blocks: as many as the SMs hold (two a SM at bn 64),
        at most one per work item."""
        return min(self.blocks, GEMM_SMS * (2 if self.bn == 64 else 1))

    def split_range(self, s: int) -> Tuple[int, int]:
        return (s * self.k_tiles // self.splits,
                (s + 1) * self.k_tiles // self.splits)

    @property
    def partials(self) -> int:
        """The f32 tiles a split tile leaves in the workspace: one a split,
        or with ``term_slots`` split 0's and one a later K-tile."""
        if self.term_slots:
            return 1 + self.k_tiles - self.split_range(0)[1]
        return self.splits

    @property
    def workspace_bytes(self) -> int:
        """The f32 partials of every tile (none unsplit)."""
        return 0 if self.splits == 1 else \
            self.partials * self.tiles * self.bm * self.bn * 4


@functools.lru_cache(maxsize=4096)
def gemm_plan(layout: int, M: int, N: int, K: int) -> GemmPlan:
    """The plan of an [M, N] output summed over K (for dW, K = R rows),
    from the shape alone (cached: the small-batch forward is bound by the
    host's time per launch). Tiles of 128 x 128 (one block per SM) where they
    fill the SMs, or for every layout but dW half of them; else 128 x 64
    (two blocks per SM), which the step's dW shapes and the encoder's narrow
    dX ran faster at on the card. The int4 products take 128 weight
    columns a tile and 64 activation rows (S4; W4 up to M 64) or 128 (W4).
    K-tiles of 64 bf16 values (NT, TN, NN and the bf16-dequant int4
    product W4), 128 int8 ones (S8) or one 128-row scale group of int4
    codes (S4). Then, for dW, as many splits of whole K-tiles as bring the
    blocks to the SM count, at most one K-tile each; for the int4 products
    as many as the SMs hold whole, up to ``INT4_MAX_SPLITS``, each of at
    least ``INT4_SPLIT_MIN_TILES`` K-tiles (the B=1 sites walk K in order
    on a few SMs; S4 keeps its groups' order by the prefix rule,
    ``term_slots``). dX, NN and S8 do not split: their partials would be as
    large as their outputs, and the card ran the encoder's dX slower
    split."""
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    int4 = layout in (_S4, _W4)
    bm = GEMM_BM if not int4 else 64 if layout == _S4 or M <= 64 else 128
    tiles_m = cdiv(M, bm)
    tiles128 = tiles_m * cdiv(N, 128)
    bn = 128 if tiles128 >= GEMM_SMS or int4 or (
        layout != _TN and 2 * tiles128 >= GEMM_SMS) else 64
    tiles = tiles_m * cdiv(N, bn)
    bk = GEMM_BK_S8 if layout == _S8 else W4_GROUP if layout == _S4 \
        else GEMM_BK
    k_tiles = cdiv(K, bk)
    splits = 1
    if layout == _TN and 0 < tiles < GEMM_SMS:
        splits = max(1, min(cdiv(GEMM_SMS, tiles), k_tiles))
    elif int4 and 0 < tiles < GEMM_SMS:
        splits = max(1, min(GEMM_SMS // tiles,
                            k_tiles // INT4_SPLIT_MIN_TILES[layout],
                            INT4_MAX_SPLITS))
    return GemmPlan(bm, bn, bk, tiles_m, cdiv(N, bn), k_tiles, splits,
                    layout == _S4)


SMEM_PER_BLOCK = 232448   # an H100 block's dynamic shared memory at most


def int4_smem_bytes(layout: int, bm: int) -> int:
    """The dynamic shared memory of gemm_int4.cu's instance at bm
    activation rows a tile (Int4Cfg::SMEM, which ``mcan_gemm_int4_smem``
    returns on the card): a ring of ``INT4_STAGES`` slots (the activations,
    bm rows x 128 bytes; the packed weight, 128 columns x 128 bytes for S4,
    x 64 for W4; the slot's 128 group scales), S4's second box of a
    straddling group (128 x 128), 1 KB of slack to align the ring, the
    barriers, a flag and the eight warps' epilogue staging rows (64 x 20
    f32 each)."""
    stages = INT4_STAGES[layout, bm]
    slot = bm * 128 + 128 * (128 if layout == _S4 else 64) + 128 * 4
    return (1024 + stages * slot + (128 * 128 if layout == _S4 else 0)
            + 16 * stages + 16 + 8 * 64 * 20 * 4)


_SPLIT_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_COL_SUM_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _zeroed_counters(table: Dict[torch.device, torch.Tensor],
                     device: torch.device, n: int, what: str) -> torch.Tensor:
    """At least n int32 counters of one kernel on one device, zeroed once
    and left at 0 by every launch (the last block of a split resets its
    counter); a capture cannot make them."""
    c = table.get(device)
    if c is None or c.numel() < n:
        _require(device.type != "cuda"
                 or not torch.cuda.is_current_stream_capturing(),
                 f"{what} are made at the first split launch on a device; "
                 f"make it outside a graph capture")
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        table[device] = c
    return c


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """One counter per output tile of a split gemm_sm90.cu or gemm_int4.cu
    launch."""
    return _zeroed_counters(_SPLIT_COUNTERS, device, n,
                            "gemm_sm90: the split-K counters")


def _split_args(plan: GemmPlan, device: torch.device):
    """A split plan's workspace and the device's tile counters; (None,
    None) unsplit."""
    if plan.splits == 1:
        return None, None
    return (torch.empty(plan.workspace_bytes // 4, dtype=F32, device=device),
            _split_counters(device, plan.tiles))


def _check_gemm(name: str, a: torch.Tensor, b: torch.Tensor, N: int,
                reduced: int, out_dtypes, gate=None, res=None,
                bias=None, mask=None, M: int = 0) -> None:
    """Every operand of a GEMM launch: both bf16, read in whole 16-byte
    chunks along their rows (unit column stride, row strides that are
    multiples of 8, 16-byte alignment); N and the width read along each
    row of A (``reduced``: K, or for dW the output's M -- the R rows
    themselves may be any number) multiples of 8."""
    _same_device(name, a, b, bias, mask, gate, res)
    _require(a.dtype == BF16 and b.dtype == BF16,
             f"{name}: operands must be bf16, got {a.dtype}, {b.dtype}")
    _require(N % GEMM_ALIGN == 0 and reduced % GEMM_ALIGN == 0,
             f"{name}: N={N} must be a multiple of {GEMM_ALIGN}, and K="
             f"{reduced} too (for dW: M={reduced})")
    _require(a.dim() == 2 and b.dim() == 2 and a.stride(1) == 1
             and b.stride(1) == 1 and a.stride(0) % 8 == 0
             and b.stride(0) % 8 == 0 and a.data_ptr() % 16 == 0
             and b.data_ptr() % 16 == 0,
             f"{name}: operands need unit column stride, row strides that "
             f"are multiples of 8 and 16-byte alignment")
    _require(len(out_dtypes) > 0 and set(out_dtypes) <= {F32, BF16}
             and len(set(out_dtypes)) == len(out_dtypes),
             f"{name}: out_dtypes {out_dtypes}")
    _check_vec(name, bias, N)
    _check_mask(name, mask, (M, N))
    _require(mask is None or mask.data_ptr() % 2 == 0,
             f"{name}: the dropout mask must start on an even address (its "
             f"bytes are read in pairs)")
    _check_rows(name, gate, (M, N), (BF16,))
    _check_rows(name, res, (M, N), (F32,))


def _gemm(name: str, a: torch.Tensor, b: torch.Tensor, M: int, N: int,
          K: int, *, bias=None, relu=False, mask=None, inv_keep=1.0,
          out_dtype: torch.dtype = F32) -> torch.Tensor:
    """Launch gemm_sm90.cu's NN layout: a [M, K] . b [K, N] and its
    epilogue (bias, ReLU, the keep-mask or its Philox source)."""
    return _gemm_sm90(name, _NN, a, b, M, N, K, bias=bias, relu=relu,
                      mask=mask, inv_keep=inv_keep,
                      out_dtypes=(out_dtype,))[0]


def _gemm_sm90(name: str, layout: int, a: torch.Tensor, b: torch.Tensor,
               M: int, N: int, K: int, *, gate=None, inv_keep=1.0, res=None,
               bias=None, relu=False, mask: Keep = None,
               out_dtypes: Sequence[torch.dtype] = (F32,)
               ) -> Tuple[torch.Tensor, ...]:
    """Launch csrc/gemm_sm90.cu (layout _NN: a [M, K] . b [K, N]; _NT:
    a [M, K] . b [N, K]^T; _TN: a [K, M]^T . b [K, N]) with the plan of
    ``gemm_plan``; a split plan gets its workspace here and the device's
    tile counters."""
    mask, keep = _keep_args(name, mask, M)
    _check_gemm(name, a, b, N, M if layout == _TN else K, out_dtypes,
                gate=gate, res=res, bias=bias, mask=mask, M=M)
    plan = gemm_plan(layout, M, N, K)
    outs = {dt: torch.empty((M, N), dtype=dt, device=a.device)
            for dt in out_dtypes}
    ws, counters = _split_args(plan, a.device)
    rc = _lib().mcan_gemm_sm90(
        layout, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        M, N, K, plan.bn, plan.splits, plan.grid, _ptr(gate),
        0 if gate is None else gate.stride(0), float(inv_keep), _ptr(res),
        0 if res is None else res.stride(0), _ptr(bias), int(relu),
        _ptr(mask), N if mask is not None else 0, *keep,
        _ptr(outs.get(F32)), _ptr(outs.get(BF16)), _ptr(ws), _ptr(counters),
        _stream(a))
    _check(rc, name)
    return tuple(outs[dt] for dt in out_dtypes)


def gemm_bias_act_plain(a: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        relu: bool = False, out_dtype: torch.dtype = F32,
                        mask: Keep = None,
                        inv_keep: float = 1.0) -> torch.Tensor:
    if isinstance(mask, Philox):
        mask = _rows_keep(mask, a.shape[0], w.shape[1], a.device)
    y = bf16_matmul(a, w)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return _drop(y, mask, inv_keep).to(out_dtype)


def gemm_bias_act(a: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *, relu: bool = False,
                  out_dtype: torch.dtype = F32,
                  mask: Keep = None,
                  inv_keep: float = 1.0) -> torch.Tensor:
    """a [M, K] bf16 . w [K, N] bf16 + bias [N] f32, then ReLU, then the
    dropout keep-mask [M, N] or its Philox source (x inv_keep) -> [M, N]
    in out_dtype (f32 or bf16), accumulated in f32 and rounded once."""
    if exporting():
        return _ops().gemm_bias_act(a, w, bias, relu=relu,
                                    out_dtype=out_dtype, mask=mask,
                                    inv_keep=inv_keep)
    if not on_cuda(a):
        return gemm_bias_act_plain(a, w, bias, relu=relu,
                                   out_dtype=out_dtype, mask=mask,
                                   inv_keep=inv_keep)
    M, K = a.shape
    _require(w.shape[0] == K, f"gemm_bias_act: a {tuple(a.shape)} . w "
             f"{tuple(w.shape)} do not chain")
    return _gemm("gemm_bias_act", a, w, M, w.shape[1], K, bias=bias,
                 relu=relu, mask=mask, inv_keep=inv_keep,
                 out_dtype=out_dtype)


def gemm_dx_plain(dy: torch.Tensor, w: torch.Tensor, *,
                  gate: Optional[torch.Tensor] = None, inv_keep: float = 1.0,
                  res: Optional[torch.Tensor] = None,
                  out_dtypes: Sequence[torch.dtype] = (F32,)
                  ) -> Tuple[torch.Tensor, ...]:
    y = bf16_matmul(dy, w.t())
    if gate is not None:
        y = torch.where(gate.float() > 0, y * inv_keep, torch.zeros_like(y))
    if res is not None:
        y = res + y
    return tuple(y.to(dt) for dt in out_dtypes)


def gemm_dx(dy: torch.Tensor, w: torch.Tensor, *,
            gate: Optional[torch.Tensor] = None, inv_keep: float = 1.0,
            res: Optional[torch.Tensor] = None,
            out_dtypes: Sequence[torch.dtype] = (F32,)
            ) -> Tuple[torch.Tensor, ...]:
    """The input gradient of ``x . w``: dy [M, K] bf16 . w[N, K]^T (w the
    forward weight [in=N, out=K], bf16). Then, where ``gate`` (bf16
    [M, N]) is > 0 the value times inv_keep, else 0 -- the gradient through
    a ReLU with dropout after it, read off its bf16 output (sga_train.py:599)
    -- then + res (f32 [M, N]). Returns one tensor per out_dtypes."""
    if not on_cuda(dy):
        return gemm_dx_plain(dy, w, gate=gate, inv_keep=inv_keep, res=res,
                             out_dtypes=out_dtypes)
    M, K = dy.shape
    _require(w.shape[1] == K, f"gemm_dx: dy {tuple(dy.shape)} . w^T "
             f"{tuple(w.shape)} do not chain")
    return _gemm_sm90("gemm_dx", _NT, dy, w, M, w.shape[0], K, gate=gate,
                      inv_keep=inv_keep, res=res, out_dtypes=out_dtypes)


def gemm_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return bf16_matmul(x.t(), dy)


def gemm_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight gradient of ``x . w``: x [R, M]^T . dy [R, N], both bf16,
    -> f32 [M, N], summed over the R rows in ``gemm_plan``'s splits, whose
    partials are added in split order (the same bits on every run)."""
    if not on_cuda(x):
        return gemm_dw_plain(x, dy)
    R, M = x.shape
    _require(dy.shape[0] == R, f"gemm_dw: x {tuple(x.shape)} and dy "
             f"{tuple(dy.shape)} have different rows")
    return _gemm_sm90("gemm_dw", _TN, x, dy, M, dy.shape[1], R)[0]


# gemm_ln.cu: a row block's D columns over the CTAs of one thread-block
# cluster, which exchange the LayerNorm's row statistics
GEMM_LN_MAX_CLUSTER = 8    # CTAs a cluster: the portable size
# the instances' tiles (rows, columns a CTA: one or two consumer warpgroups
# of wgmma m64nBNk16) -> their ring slots (gemm_ln.cu's Cfg::STAGES), for a
# bf16 and an f32 a; 64 x 128 runs two CTAs an SM, the others one
GEMM_LN_STAGES = {(64, 64): (12, 8), (64, 128): (4, 3), (64, 256): (4, 4),
                  (128, 128): (6, 4)}
GEMM_LN_TILES = tuple(GEMM_LN_STAGES)
GEMM_LN_FILL = 0.9         # 128 x 128 tiles where they fill this share of SMs
_BOX = 64 * GEMM_BK * 2    # one 64 x 64 bf16 TMA box (a 64 x 32 f32 one)


def gemm_ln_smem_bytes(a_f32: bool, bm: int, bn: int) -> int:
    """The dynamic shared memory of gemm_ln.cu's instance (Cfg::SMEM, which
    ``mcan_gemm_ln_smem`` returns on the card): 1 KB of slack to align the
    ring, the ring (a slot: A, bm / 64 boxes of 64 rows of bf16, twice
    that of f32; W, bn / 64 boxes), its barriers, the rows' (sum, M2,
    mean) in 16 bytes each and the columns' bias, gamma and beta."""
    stages = GEMM_LN_STAGES[bm, bn][bool(a_f32)]
    slot = bm // 64 * (2 if a_f32 else 1) * _BOX + bn // 64 * _BOX
    return 1024 + stages * slot + 16 * stages + 4 * bm * 4 + 3 * bn * 4


@dataclass(frozen=True)
class GemmLnPlan:
    """How gemm_ln.cu covers one call (``gemm_ln_plan``): row blocks of
    ``bm`` rows, each one cluster of ``cluster`` CTAs of ``bn`` columns
    (rank c owns ``columns(c)``), the K-tiles of 64 walked in order by each
    CTA (K is not split), the instance's ring ``stages`` and dynamic shared
    memory ``smem``."""
    M: int
    K: int
    D: int
    a_f32: bool
    bm: int
    bn: int
    cluster: int
    stages: int
    smem: int

    @property
    def row_blocks(self) -> int:
        return -(-self.M // self.bm)

    @property
    def k_tiles(self) -> int:
        return -(-self.K // GEMM_BK)

    @property
    def grid(self) -> int:
        return self.cluster * self.row_blocks

    def rows(self, block: int) -> Tuple[int, int]:
        return block * self.bm, min(self.M, (block + 1) * self.bm)

    def columns(self, rank: int) -> Tuple[int, int]:
        return rank * self.bn, min(self.D, (rank + 1) * self.bn)

    def fields(self) -> Tuple[int, ...]:
        """What mcan_gemm_ln takes of the plan: bm, bn, cluster, grid,
        k_tiles, stages, smem."""
        return (self.bm, self.bn, self.cluster, self.grid, self.k_tiles,
                self.stages, self.smem)


def _check_gemm_ln_shape(name: str, K: int, D: int) -> None:
    _require(K % GEMM_ALIGN == 0 and K >= GEMM_ALIGN and D % GEMM_ALIGN == 0
             and GEMM_ALIGN <= D <= LN_MAX_WIDTH,
             f"{name}: K={K} and D={D} must be multiples of {GEMM_ALIGN}, "
             f"D up to {LN_MAX_WIDTH}")


def _gemm_ln_tile_plan(M: int, K: int, D: int, a_f32: bool, bm: int,
                       bn: int) -> GemmLnPlan:
    """The plan of one call at the tile bm x bn (an instance's)."""
    _require((bm, bn) in GEMM_LN_STAGES, f"gemm_ln: no {bm} x {bn} instance")
    cluster = -(-D // bn)
    _require(cluster <= GEMM_LN_MAX_CLUSTER,
             f"gemm_ln: D={D} needs {cluster} CTAs of {bn} columns")
    a_f32 = bool(a_f32)
    return GemmLnPlan(M, K, D, a_f32, bm, bn, cluster,
                      GEMM_LN_STAGES[bm, bn][a_f32],
                      gemm_ln_smem_bytes(a_f32, bm, bn))


@functools.lru_cache(maxsize=1024)
def gemm_ln_plan(M: int, K: int, D: int, a_f32: bool) -> GemmLnPlan:
    """The plan of one gemm_ln call from the shape alone. A cluster's CTAs
    split the D columns, at most ``GEMM_LN_MAX_CLUSTER`` of them. Tiles of
    128 x 128 (two warpgroups: half the weight's reloads of a 64-row tile)
    where their CTAs give at least ``GEMM_LN_FILL`` of the card's SMs one
    each; else 64-row tiles: of the widths that need no more than the
    cluster limit, the widest whose CTAs (row blocks x cluster) cover the
    SMs, else the narrowest (the most CTAs). So MCAN-small's decoder (M
    3840) runs 120 CTAs of 128 x 128 in clusters of 4, its encoder (M 896)
    112 of 64 x 64 in clusters of 8, and D 1536 / 2048 clusters of 6 / 8
    CTAs of 64 x 256. K is not split: at B = 1 one cluster walks all of it."""
    _check_gemm_ln_shape("gemm_ln_plan", K, D)
    _require(M >= 0, f"gemm_ln_plan: M={M}")
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    if cdiv(D, 128) <= GEMM_LN_MAX_CLUSTER and \
            cdiv(M, 128) * cdiv(D, 128) >= GEMM_LN_FILL * GEMM_SMS:
        return _gemm_ln_tile_plan(M, K, D, a_f32, 128, 128)
    rows = cdiv(M, 64)
    widths = [bn for bn in (64, 128, 256)
              if cdiv(D, bn) <= GEMM_LN_MAX_CLUSTER]
    filling = [bn for bn in widths if rows * cdiv(D, bn) >= GEMM_SMS]
    bn = max(filling) if filling else min(widths)
    return _gemm_ln_tile_plan(M, K, D, a_f32, 64, bn)


def gemm_ln_plain(a: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor], res: torch.Tensor,
                  gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return residual_layernorm_plain(res, bf16_matmul(a, w), bias, gamma,
                                    beta, (res.dtype,))[0]


def gemm_ln(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            res: torch.Tensor, gamma: torch.Tensor,
            beta: torch.Tensor) -> torch.Tensor:
    """StdLayerNorm(res + a . w + bias) over the last dim -> [M, D] in res's
    dtype: a [M, K] bf16 or f32 (rounded to bf16 in the kernel), w [K, D]
    bf16, the products summed in f32, bias / gamma / beta [D] f32 (bias may
    be None), res [M, D] f32 or bf16, the reference LayerNorm (Bessel std,
    eps on the std, divided) in f32. K and D multiples of 8, D up to 2048,
    any M (``_proj_ln_kernel`` / the second half of ``_ffn_ln_kernel``,
    mcan_vqa_tpu/ops/fused_ffn.py:59 / :46). On the card, ``gemm_ln_plan``'s
    clusters."""
    if exporting():
        return _ops().gemm_ln(a, w, bias, res, gamma, beta)
    if not on_cuda(a):
        return gemm_ln_plain(a, w, bias, res, gamma, beta)
    name = "gemm_ln"
    _same_device(name, a, w, bias, res, gamma, beta)
    _require(a.dim() == 2 and w.dim() == 2 and a.shape[1] == w.shape[0],
             f"{name}: a {tuple(a.shape)} . w {tuple(w.shape)} do not chain")
    M, Kd = a.shape
    D = w.shape[1]
    _require(a.dtype in (BF16, F32) and w.dtype == BF16,
             f"{name}: a must be bf16 or f32 and w bf16, got {a.dtype}, "
             f"{w.dtype}")
    _check_gemm_ln_shape(name, Kd, D)
    _require(a.stride(1) == 1 and w.stride(1) == 1 and a.stride(0) % 8 == 0
             and w.stride(0) % 8 == 0 and a.data_ptr() % 16 == 0
             and w.data_ptr() % 16 == 0,
             f"{name}: a and w need unit column stride, row strides that are "
             f"multiples of 8 and 16-byte alignment")
    _check_rows(name, res, (M, D), (F32, BF16))
    for t in (bias, gamma, beta):
        _check_vec(name, t, D)
    if res.stride(0) % 8 or res.data_ptr() % 16:
        # the kernel reads the residual's rows 16 bytes at a time
        res = res.clone(memory_format=torch.contiguous_format)
    plan = gemm_ln_plan(M, Kd, D, a.dtype == F32)
    out = torch.empty((M, D), dtype=res.dtype, device=a.device)
    rc = _lib().mcan_gemm_ln(
        a.data_ptr(), int(a.dtype == F32), a.stride(0), w.data_ptr(),
        w.stride(0), _ptr(bias), res.data_ptr(), int(res.dtype == BF16),
        res.stride(0), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), D,
        M, D, Kd, LN_EPS, *plan.fields(), _stream(a))
    _check(rc, name)
    return out


# ---------------------------------------------------------------------------
# the int8 GEMM and the activation quantization (the int8 serving blocks)
# ---------------------------------------------------------------------------

def quantize_rows_plain(x: torch.Tensor, inv_a: Optional[float] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    x32 = x.float()
    if inv_a is None:
        s = true_div(x32.abs().amax(dim=-1), 127.0)
        s = torch.where(s == 0.0, torch.ones_like(s), s)
        q = torch.round(x32 / s[:, None])
    else:
        s = None
        q = torch.round(x32 * _f32(inv_a))
    return q.clamp_(-127.0, 127.0).to(I8), s


def quantize_rows(x: torch.Tensor, inv_a: Optional[float] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Symmetric int8 codes of the rows of x [M, K] (f32 or bf16, unit
    column stride) -> (int8 [M, K], f32 scales [M] or None).

    inv_a None: dynamic per-row scales s = max|x| / 127 (0 -> 1) and codes
    clip(round(x / s), -127, 127), a true division (``_qrow``,
    mcan_vqa_tpu/ops/quant.py:245). inv_a given: the static codes
    clip(round(x * inv_a), -127, 127) with inv_a = 1 / a rounded to f32
    (``_qdot_static``, quant.py:275); no scales. Rounding is half to even.
    The kernel gives the plain version's codes and scales bit for bit."""
    if exporting():
        return _ops().quantize_rows(x, inv_a)
    if not on_cuda(x):
        return quantize_rows_plain(x, inv_a)
    name = "quantize_rows"
    _require(x.dim() == 2 and x.dtype in (F32, BF16) and x.stride(1) == 1,
             f"{name}: x must be f32 or bf16 [M, K] with unit column stride,"
             f" got {tuple(x.shape)} {x.dtype}")
    M, Kd = x.shape
    q = torch.empty((M, Kd), dtype=I8, device=x.device)
    s = torch.empty(M, dtype=F32, device=x.device) if inv_a is None else None
    rc = _lib().mcan_quantize_rows(
        x.data_ptr(), int(x.dtype == BF16), x.stride(0), M, Kd,
        int(inv_a is None), 0.0 if inv_a is None else _f32(inv_a),
        q.data_ptr(), _ptr(s), _stream(x))
    _check(rc, name)
    return q, s


def int8_dot_exact(aq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] . int8 [K, N] -> the f32 value of the exact int32 sums:
    f64 sums of int8 products are exact integers (|acc| <= 127^2 K <
    2^53) on either device, and their one rounding to f32 is the kernels'
    int32 -> f32 conversion."""
    return (aq.double() @ wq.double()).float()


def gemm_s8_plain(aq: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  sx: Optional[torch.Tensor] = None, a: Optional[float] = None,
                  relu: bool = False,
                  out_dtypes: Sequence[torch.dtype] = (F32,)
                  ) -> Tuple[torch.Tensor, ...]:
    scale = sx[:, None] * sw if sx is not None else _f32(a) * sw
    y = int8_dot_exact(aq, wq) * scale
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return tuple(y.to(dt) for dt in out_dtypes)


def k_major(w: torch.Tensor) -> torch.Tensor:
    """w [K, N] -> the same values in the same shape, stored K-major
    (strides (1, K)): the layout ``gemm_s8`` reads an int8 weight in, made
    once where an engine is prepared (wgmma takes an 8-bit operand only
    with K contiguous in shared memory)."""
    return w.t().contiguous().t()


def _is_k_major(w: torch.Tensor) -> bool:
    """[K, N] stored K-major: unit stride along K, and a column stride the
    tensor map steps over in whole 16-byte units, at least K (any stride
    for one column)."""
    K, N = w.shape
    return w.stride(0) == 1 and (N == 1 or (w.stride(1) % 16 == 0
                                            and w.stride(1) >= K))


def gemm_s8(aq: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            sx: Optional[torch.Tensor] = None, a: Optional[float] = None,
            relu: bool = False, out_dtypes: Sequence[torch.dtype] = (F32,)
            ) -> Tuple[torch.Tensor, ...]:
    """aq [M, K] int8 . wq [K, N] int8 (the JAX [in, out] shape, stored
    K-major: ``k_major``), summed exactly in int32, then f32(acc) * (sx[m]
    * sw[n]) with the per-row activation scales sx (dynamic, ``_qdot``,
    quant.py:253) or f32(acc) * (a * sw[n]) with one static scale a
    (``_qdot_static``, :263), + bias [N], then ReLU -> one [M, N] tensor
    per out_dtypes (f32 and/or bf16), launched as gemm_sm90.cu's S8 layout
    with the plan of ``gemm_plan``. Pass exactly one of sx and a. K must
    be a multiple of 16; any M and N. A weight stored otherwise raises: it
    is never transposed per call."""
    if exporting():
        return _ops().gemm_s8(aq, wq, sw, bias, sx=sx, a=a, relu=relu,
                              out_dtypes=out_dtypes)
    if not on_cuda(aq):
        return gemm_s8_plain(aq, wq, sw, bias, sx=sx, a=a, relu=relu,
                             out_dtypes=out_dtypes)
    name = "gemm_s8"
    _same_device(name, aq, wq, sw, bias, sx)
    _require((sx is None) != (a is None),
             f"{name}: pass per-row scales sx or a static scale a")
    _require(aq.dtype == I8 and wq.dtype == I8 and aq.dim() == 2
             and wq.dim() == 2 and aq.shape[1] == wq.shape[0],
             f"{name}: int8 [M, K] . int8 [K, N] expected, got "
             f"{tuple(aq.shape)} {aq.dtype} . {tuple(wq.shape)} {wq.dtype}")
    M, Kd = aq.shape
    N = wq.shape[1]
    _require(Kd % 16 == 0 and aq.stride(1) == 1 and aq.stride(0) % 16 == 0
             and aq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0,
             f"{name}: K={Kd} and the codes' row stride must be multiples "
             f"of 16, with unit column stride and 16-byte alignment")
    _require(_is_k_major(wq),
             f"{name}: the weight must be stored K-major (strides (1, ld), "
             f"ld >= K a multiple of 16: kernels.k_major), got strides "
             f"{wq.stride()}")
    _check_vec(name, sw, N)
    _check_vec(name, bias, N)
    _require(sx is None or (sx.dtype == F32 and sx.is_contiguous()
                            and sx.numel() == M),
             f"{name}: sx must be f32 [{M}]")
    _require(len(out_dtypes) > 0 and set(out_dtypes) <= {F32, BF16}
             and len(set(out_dtypes)) == len(out_dtypes),
             f"{name}: out_dtypes {out_dtypes}")
    plan = gemm_plan(_S8, M, N, Kd)
    outs = {dt: torch.empty((M, N), dtype=dt, device=aq.device)
            for dt in out_dtypes}
    rc = _lib().mcan_gemm_sm90_s8(
        aq.data_ptr(), aq.stride(0), wq.data_ptr(),
        wq.stride(1) if N > 1 else Kd, M, N, Kd, plan.bn, plan.grid,
        _ptr(sx), 0.0 if a is None else _f32(a), sw.data_ptr(), _ptr(bias),
        int(relu), _ptr(outs.get(F32)), _ptr(outs.get(BF16)), _stream(aq))
    _check(rc, name)
    return tuple(outs[dt] for dt in out_dtypes)


# ---------------------------------------------------------------------------
# the int4 GEMMs (the int4 serving levels 4-7)
# ---------------------------------------------------------------------------

W4_GROUP = 128     # K-rows per int4 scale group: gemm_s4's K-tile


def unpack_w4(packed: torch.Tensor) -> torch.Tensor:
    """[K/2, N] nibble-packed int8 -> [K, N] int8 in [-7, 7]
    (``_unpack_w4``, mcan_vqa_tpu/ops/quant.py:81): row j is the low nibble
    of packed row j, row j + K/2 its high nibble, each minus 8."""
    p = packed.to(torch.int32) & 0xFF
    return torch.cat([(p & 0xF) - 8, (p >> 4) - 8], dim=0).to(I8)


def dequant_w4(packed: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """The bf16 weight of ``_qdot_w4bf16`` (quant.py:307): bf16(f32(q) *
    s4[group]) for packed int4 q and f32 group scales s4 [K/g, N]."""
    w = unpack_w4(packed).float()
    K, N = w.shape
    nG = s4.shape[0]
    return (w.reshape(nG, K // nG, N) * s4[:, None, :]).reshape(K, N) \
        .to(BF16)


def w4_tile_boxes(K: int, t: int) -> Tuple[Optional[int], Optional[int]]:
    """The packed boxes of gemm_s4's K-tile t (scale group t, codes k =
    128 t .. 128 t + 127): (the byte at which its low-nibble box starts,
    that of its high-nibble box), None where it has none. Each box is 128
    bytes of every column's K-major packed row. Below K/2 a group is low
    nibbles of bytes 128 t ..; past it high nibbles of bytes 128 t - K/2
    ..; where K % 256 != 0 the group that straddles K/2 has both, the
    second at byte 0 (``w4_code_source`` says which code each position
    holds). gemm_int4.cu's producer loads these boxes."""
    half, k0 = K // 2, W4_GROUP * t
    lo = k0 if k0 < half else None
    hi = max(k0 - half, 0) if k0 + W4_GROUP > half else None
    return lo, hi


def w4_code_source(K: int, t: int, p: int) -> Tuple[str, int, int]:
    """Where code p of gemm_s4's K-tile t lies: ("lo" or "hi", its position
    in that box of ``w4_tile_boxes``, 0 for the low nibble or 4 for the
    high one). The low box's codes keep their positions; a straddling
    group's codes 64 .. 127 sit 64 positions back in its high box (the
    same 16-byte chunk XOR 4 under the 128-byte swizzle), so the kernel
    unpacks every code from the same row of the slot."""
    half, k = K // 2, W4_GROUP * t + p
    lo, hi = w4_tile_boxes(K, t)
    if k < half:
        return "lo", k - lo, 0
    return "hi", k - half - hi, 4


def w4bf16_tile(K: int, t: int) -> Tuple[int, int, int]:
    """gemm_w4bf16's K-tile t (rows 64 t .. 64 t + 63, one scale group and
    one nibble half: K/2 is a multiple of 64) -> (the packed byte its
    64-byte box starts at, 0 for the low nibbles or 4 for the high ones,
    its scale group)."""
    half, k0 = K // 2, GEMM_BK * t
    return (k0, 0, k0 // W4_GROUP) if k0 < half else \
        (k0 - half, 4, k0 // W4_GROUP)


def _check_w4(name, wp, s4, Kd, N):
    _require(wp.dtype == I8 and wp.dim() == 2 and wp.shape[0] * 2 == Kd,
             f"{name}: packed weight must be int8 [{Kd // 2}, N], got "
             f"{tuple(wp.shape)} {wp.dtype}")
    _require(Kd % W4_GROUP == 0 and Kd > 0 and N % 16 == 0,
             f"{name}: K={Kd} must be a multiple of {W4_GROUP} (one "
             f"{W4_GROUP}-row scale group per K-tile) and N={N} of 16")
    _require(s4.dtype == F32 and s4.is_contiguous()
             and s4.data_ptr() % 16 == 0
             and tuple(s4.shape) == (Kd // W4_GROUP, N),
             f"{name}: group scales must be f32 [{Kd // W4_GROUP}, {N}], "
             f"contiguous and 16-byte aligned, got {tuple(s4.shape)} "
             f"{s4.dtype}")
    _require(_is_k_major(wp) and wp.data_ptr() % 16 == 0,
             f"{name}: the packed weight must be stored K-major (strides "
             f"(1, ld), ld >= K/2 a multiple of 16: kernels.k_major, as "
             f"_quant_w4 stores it) and 16-byte aligned, got strides "
             f"{wp.stride()}")


def gemm_s4_plain(aq: torch.Tensor, wp: torch.Tensor, s4: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *, a: float,
                  relu: bool = False,
                  out_dtypes: Sequence[torch.dtype] = (F32,)
                  ) -> Tuple[torch.Tensor, ...]:
    w = unpack_w4(wp)
    nG = s4.shape[0]
    g = w.shape[0] // nG
    scale = _f32(a) * s4
    y = None
    for gi in range(nG):
        t = int8_dot_exact(aq[:, gi * g:(gi + 1) * g],
                           w[gi * g:(gi + 1) * g]) * scale[gi]
        y = t if y is None else y + t
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return tuple(y.to(dt) for dt in out_dtypes)


def gemm_s4(aq: torch.Tensor, wp: torch.Tensor, s4: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *, a: float,
            relu: bool = False, out_dtypes: Sequence[torch.dtype] = (F32,)
            ) -> Tuple[torch.Tensor, ...]:
    """aq [M, K] int8 (static codes, ``quantize_rows(x, 1 / a)``) against
    the nibble-packed int4 weight wp [K/2, N] (stored K-major, as
    ``_quant_w4`` stores it) with group scales s4 [K/128, N]: per K-group
    gi, in order, t = f32(exact int32 sum) * (a * s4[gi]); y = t0 + t1 +
    ..., + bias [N], then ReLU -> one [M, N] tensor per out_dtypes
    (``_qdot_static4``, mcan_vqa_tpu/ops/quant.py:282), launched as
    gemm_int4.cu's S4 layout with the plan of ``gemm_plan`` (split K at
    small M by the prefix rule: the groups' terms still added in order). The
    kernel reads the weight packed and gives the plain version's bits. A
    packed weight stored otherwise raises: it is never transposed per
    call."""
    if exporting():
        return _ops().gemm_s4(aq, wp, s4, bias, a=a, relu=relu,
                              out_dtypes=out_dtypes)
    if not on_cuda(aq):
        return gemm_s4_plain(aq, wp, s4, bias, a=a, relu=relu,
                             out_dtypes=out_dtypes)
    name = "gemm_s4"
    _same_device(name, aq, wp, s4, bias)
    _require(aq.dtype == I8 and aq.dim() == 2,
             f"{name}: codes must be int8 [M, K], got {tuple(aq.shape)} "
             f"{aq.dtype}")
    M, Kd = aq.shape
    N = wp.shape[1]
    _check_w4(name, wp, s4, Kd, N)
    _require(aq.stride(1) == 1 and aq.stride(0) % 16 == 0
             and aq.data_ptr() % 16 == 0,
             f"{name}: codes need unit column stride, a row stride that is "
             f"a multiple of 16 and 16-byte alignment")
    _check_vec(name, bias, N)
    _require(len(out_dtypes) > 0 and set(out_dtypes) <= {F32, BF16}
             and len(set(out_dtypes)) == len(out_dtypes),
             f"{name}: out_dtypes {out_dtypes}")
    plan = gemm_plan(_S4, M, N, Kd)
    outs = {dt: torch.empty((M, N), dtype=dt, device=aq.device)
            for dt in out_dtypes}
    ws, counters = _split_args(plan, aq.device)
    rc = _lib().mcan_gemm_s4(
        aq.data_ptr(), aq.stride(0), wp.data_ptr(), wp.stride(1),
        s4.data_ptr(), M, N, Kd, plan.bm, plan.bn, plan.splits, plan.grid,
        _f32(a), _ptr(bias), int(relu), _ptr(outs.get(F32)),
        _ptr(outs.get(BF16)), _ptr(ws), _ptr(counters), _stream(aq))
    _check(rc, name)
    return tuple(outs[dt] for dt in out_dtypes)


def gemm_w4bf16_plain(x: torch.Tensor, wp: torch.Tensor, s4: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *,
                      relu: bool = False, out_dtype: torch.dtype = F32
                      ) -> torch.Tensor:
    return gemm_bias_act_plain(x, dequant_w4(wp, s4), bias, relu=relu,
                               out_dtype=out_dtype)


def gemm_w4bf16(x: torch.Tensor, wp: torch.Tensor, s4: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, relu: bool = False,
                out_dtype: torch.dtype = F32) -> torch.Tensor:
    """x [M, K] bf16 . the int4 weight wp [K/2, N] (stored K-major, as
    ``_quant_w4`` stores it) dequantized to bf16 with its group scales s4
    [K/128, N] (``dequant_w4``) + bias [N], then ReLU -> [M, N] in
    out_dtype (f32 or bf16), accumulated in f32 (``_qdot_w4bf16``,
    mcan_vqa_tpu/ops/quant.py:307), launched as gemm_int4.cu's W4 layout
    with the plan of ``gemm_plan`` (split K at small M, summed in split
    order). The kernel dequantizes each weight tile in shared memory, to the
    plain version's bits; the sums run in another order, so the two agree
    within ``gemm_bias_act``'s tolerance. A packed weight stored otherwise
    raises."""
    if exporting():
        return _ops().gemm_w4bf16(x, wp, s4, bias, relu=relu,
                                  out_dtype=out_dtype)
    if not on_cuda(x):
        return gemm_w4bf16_plain(x, wp, s4, bias, relu=relu,
                                 out_dtype=out_dtype)
    name = "gemm_w4bf16"
    _same_device(name, x, wp, s4, bias)
    _require(x.dtype == BF16 and x.dim() == 2,
             f"{name}: x must be bf16 [M, K], got {tuple(x.shape)} {x.dtype}")
    M, Kd = x.shape
    N = wp.shape[1]
    _check_w4(name, wp, s4, Kd, N)
    _require(x.stride(1) == 1 and x.stride(0) % 8 == 0
             and x.data_ptr() % 16 == 0,
             f"{name}: x needs unit column stride, a row stride that is a "
             f"multiple of 8 and 16-byte alignment")
    _check_vec(name, bias, N)
    _require(out_dtype in (F32, BF16), f"{name}: out_dtype {out_dtype}")
    plan = gemm_plan(_W4, M, N, Kd)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws, counters = _split_args(plan, x.device)
    rc = _lib().mcan_gemm_w4bf16(
        x.data_ptr(), x.stride(0), wp.data_ptr(), wp.stride(1),
        s4.data_ptr(), M, N, Kd, plan.bm, plan.bn, plan.splits, plan.grid,
        _ptr(bias),
        int(relu), _ptr(out if out_dtype == F32 else None),
        _ptr(out if out_dtype == BF16 else None), _ptr(ws), _ptr(counters),
        _stream(x))
    _check(rc, name)
    return out


# ---------------------------------------------------------------------------
# masked_attention and its backward
# ---------------------------------------------------------------------------

def _probs(q: torch.Tensor, k: torch.Tensor,
           key_pad: torch.Tensor) -> torch.Tensor:
    """f32 softmax of the bf16 scores, PAD keys at -1e9 (per sample)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = (q.to(BF16).float() @ k.to(BF16).float().transpose(-1, -2)) * scale
    return torch.softmax(s.masked_fill(key_pad, NEG_INF), dim=-1)


def _heads_out(o: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] -> [B, L, H*Dh]."""
    B, H, L, Dh = o.shape
    return o.transpose(1, 2).reshape(B, L, H * Dh)


def _attention_keep(drop: Keep, q: torch.Tensor,
                    k: torch.Tensor) -> Optional[torch.Tensor]:
    if not isinstance(drop, Philox):
        return drop
    B, H, Lq, _ = q.shape
    return _heads_keep(drop, B, H, Lq, k.shape[2], q.device)


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_pad: torch.Tensor, drop: Keep = None,
                           inv_keep: float = 1.0,
                           out_dtype: torch.dtype = BF16) -> torch.Tensor:
    """The attention in plain ops: both products of bf16 operands with f32
    sums, JAX's ``dot(bf16, bf16, preferred_element_type=f32)``. On the
    card they are cuBLAS's bf16 tensor-core products with f32 out, the
    arithmetic of the kernel's mma.sync; on the CPU f32 products of the
    rounded operands (exact products, the same function up to the order
    of the sums)."""
    drop = _attention_keep(drop, q, k)
    if not q.is_cuda:
        if drop is None:
            out = _attention_f32(q, k, v, key_pad)
        else:
            p = _drop(_probs(q, k, key_pad), drop, inv_keep)
            out = p.to(BF16).float() @ v.to(BF16).float()
        return _heads_out(out).to(out_dtype)
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    qh, kh, vh = (t.to(BF16).reshape(B * H, t.shape[2], Dh)
                  for t in (q, k, v))
    s = torch.bmm(qh, kh.transpose(1, 2), out_dtype=F32) \
        * (1.0 / Dh ** 0.5)
    p = torch.softmax(s.view(B, H, Lq, Lk).masked_fill(key_pad, NEG_INF),
                      dim=-1)
    p = _drop(p, drop, inv_keep).to(BF16).reshape(B * H, Lq, Lk)
    out = torch.bmm(p, vh, out_dtype=F32).view(B, H, Lq, Dh)
    return _heads_out(out).to(out_dtype)


def _check_attention(name, q, k, v, key_pad, drop, q_dtypes=(BF16,)):
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    _require(k.shape == v.shape == (B, H, Lk, Dh),
             f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
             f"q {tuple(q.shape)}")
    _require(1 <= Dh <= MAX_HEAD_DIM and Lq >= 1 and Lk >= 1,
             f"{name}: needs 1 <= Dh <= {MAX_HEAD_DIM} and Lq, Lk >= 1; got "
             f"Dh={Dh}, Lq={Lq}, Lk={Lk}")
    _require(q.dtype in q_dtypes and k.dtype == v.dtype
             and k.dtype in (BF16, F32),
             f"{name}: q must be {' or '.join(str(d)[6:] for d in q_dtypes)} "
             f"and k, v both bf16 or both f32")
    _require(q.stride(3) == 1 and k.stride(3) == 1
             and k.stride() == v.stride(),
             f"{name}: last dims must be contiguous and k, v share strides")
    _require(key_pad.shape == (B, 1, 1, Lk) and key_pad.dtype == torch.bool,
             f"{name}: key_pad must be bool [{B}, 1, 1, {Lk}]")
    _check_mask(name, drop, (B, H, Lq, Lk))
    # a bool tensor is one byte of 0 / 1 per element: the kernel reads it
    # in place as uint8
    pad = key_pad.reshape(B, Lk)
    _require(pad.is_contiguous(), f"{name}: key_pad must be contiguous")
    return B, H, Lq, Lk, Dh, pad


ATT_MAX_WARPS = 8      # masked_attention.cu's blocks: up to 256 threads
ATT_LONG_KC = 64       # the long kernel's keys per chunk


@dataclass(frozen=True)
class AttentionPlan:
    """How masked_attention.cu covers one call: ``instance`` 0 (the
    one-block kernel: every key of the head staged at once, kc 64 or 128
    the keys a row holds) or 1 (the long kernel: keys streamed in chunks of
    kc = 64); head columns padded to ``dhp``; ``rows`` query rows per block
    (16 per warp, each row tile held by ``col_split`` warps, each owning
    dhp / col_split output columns); block x is (sample, head) x // tiles,
    row tile x % tiles; ``smem`` bytes of dynamic shared memory."""
    instance: int
    dhp: int
    kc: int
    rows: int
    col_split: int
    tiles: int
    grid: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=4096)
def attention_plan(B: int, H: int, Lq: int, Lk: int, Dh: int
                   ) -> AttentionPlan:
    """The plan of one masked_attention call, from the shape alone (cached:
    the small-batch forward is bound by the host's time per launch). The
    one-block kernel where Dh and Lk are at most 128 (any Lq), with Dh
    rounded up to 32; else the long kernel, Dh rounded up to 64 and, past
    128, two warps per row tile. Up to 8 warps a block, as many 16-row
    tiles as the query rows need; then halved while the blocks would not
    fill the SMs (B = 1: a block per 16 or 32 rows of a head)."""
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    if Dh <= ONE_BLOCK_ATTENTION and Lk <= ONE_BLOCK_ATTENTION:
        instance, dhp, kc, cs = 0, 32 * cdiv(Dh, 32), \
            64 if Lk <= 64 else 128, 1
    else:
        dhp = 64 * cdiv(Dh, 64)
        instance, kc, cs = 1, ATT_LONG_KC, 2 if dhp > 128 else 1
    # K and V staged whole (every key in one chunk) or in two stages of
    # 64-key chunks
    staged = 2 * 16 * cdiv(Lk, 16) if instance == 0 or Lk <= ATT_LONG_KC \
        else 4 * ATT_LONG_KC
    row_tiles = cdiv(Lq, 16)
    per_block = min(row_tiles, ATT_MAX_WARPS // cs)
    while per_block > 1 and B * H * cdiv(row_tiles, per_block) < GEMM_SMS:
        per_block = cdiv(per_block, 2)
    rows = 16 * per_block
    tiles = cdiv(Lq, rows)
    return AttentionPlan(instance, dhp, kc, rows, cs, tiles, B * H * tiles,
                         32 * per_block * cs, (rows + staged) * (dhp + 8) * 2)


ATT_BWD_ITEM_COLS = 32  # the one-block backward's phase-2 items: columns


@dataclass(frozen=True)
class AttentionBwdPlan:
    """How masked_attention_bwd.cu covers one call. ``instance`` 0 (the
    one-block kernel: a block of ``threads`` per (sample, head), the head's
    ``rows`` = Lq and ``key_rows`` = Lk rounded up to 16 staged at once,
    kc 64 or 128 the keys a row holds; phase 1 a warp per 16 query rows,
    phase 2 the items (16 keys, dK or dV, 32 columns) dealt round the
    warps) or 1 (the long kernels, keys / query rows streamed in chunks of
    kc = 64: the rows kernel, ``grid`` blocks of ``threads``, ``rows`` query
    rows each, 16 per warp, ``col_split`` warps a row tile; then the keys
    kernel, ``key_grid`` blocks of ``key_threads``, ``key_rows`` keys each,
    16 per warp per output, ``key_split`` warps a key tile: dK and dV, each
    in key_split / 2 column parts). Head columns padded to ``dhp``; block x
    of either kernel is (sample, head) x // tiles, tile x % tiles;
    ``smem`` / ``key_smem`` bytes of dynamic shared memory; ``stats`` the
    f32 scratch the long kernels need, [B, H, Lq, 4] (0 elements for the
    one-block kernel)."""
    instance: int
    dhp: int
    kc: int
    rows: int
    col_split: int
    tiles: int
    grid: int
    threads: int
    smem: int
    key_rows: int
    key_split: int
    key_tiles: int
    key_grid: int
    key_threads: int
    key_smem: int
    stats: int


@functools.lru_cache(maxsize=4096)
def attention_bwd_plan(B: int, H: int, Lq: int, Lk: int, Dh: int
                       ) -> AttentionBwdPlan:
    """The plan of one masked_attention_bwd call, from the shape alone
    (cached, as ``attention_plan``). The one-block kernel where Dh, Lq and
    Lk are at most 128, Dh rounded up to 32 and kc by Lk as the forward's
    one-block kernel (so both recompute the same probabilities): a warp
    per 16 query rows, at least four warps where phase 2 has the items.
    Else the long kernels, Dh rounded up to 64: rows and keys blocks of up
    to 8 warps, halved while the blocks would not fill the SMs."""
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    lqp, lkp = 16 * cdiv(Lq, 16), 16 * cdiv(Lk, 16)
    if max(Dh, Lq, Lk) <= ONE_BLOCK_ATTENTION:
        dhp = 32 * cdiv(Dh, 32)
        items = lkp // 16 * 2 * (dhp // ATT_BWD_ITEM_COLS)
        warps = max(lqp // 16, min(items, 4))
        smem = (2 * (lqp + lkp) * (dhp + 8) + 2 * lqp * (lkp + 8)) * 2
        return AttentionBwdPlan(0, dhp, 64 if Lk <= 64 else 128, lqp, 1, 1,
                                B * H, 32 * warps, smem, lkp, 1, 1, 0, 0, 0,
                                0)
    dhp = 64 * cdiv(Dh, 64)
    cs = 2 if dhp > 128 else 1

    def blocks(L, split):
        tiles16 = cdiv(L, 16)
        per_block = min(tiles16, ATT_MAX_WARPS // split)
        while per_block > 1 and B * H * cdiv(tiles16, per_block) < GEMM_SMS:
            per_block = cdiv(per_block, 2)
        return 16 * per_block, cdiv(L, 16 * per_block)

    def streamed(L):      # staged whole (<= 64) or two stages of 64 rows
        return 16 * cdiv(L, 16) if L <= ATT_LONG_KC else 2 * ATT_LONG_KC

    rows, tiles = blocks(Lq, cs)
    key_rows, key_tiles = blocks(Lk, 2 * cs)
    return AttentionBwdPlan(
        1, dhp, ATT_LONG_KC, rows, cs, tiles, B * H * tiles,
        rows // 16 * cs * 32, (2 * rows + 2 * streamed(Lk)) * (dhp + 8) * 2,
        key_rows, 2 * cs, key_tiles, B * H * key_tiles,
        key_rows // 16 * 2 * cs * 32,
        (2 * key_rows + 2 * streamed(Lq)) * (dhp + 8) * 2
        + 16 * streamed(Lq), B * H * Lq * 4)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_pad: torch.Tensor, drop: Keep = None,
                     inv_keep: float = 1.0,
                     out_dtype: torch.dtype = BF16) -> torch.Tensor:
    """q [B, H, Lq, Dh] bf16 or f32 (rounded to bf16 on load), k/v
    [B, H, Lk, Dh] bf16 or f32, Dh <= 256, any Lq, Lk (strided views are
    read in place; the last dim must be contiguous), key_pad bool
    [B, 1, 1, Lk] (True = PAD), drop an optional keep-mask [B, H, Lq, Lk]
    on the probabilities or its Philox source -> [B, Lq, H*Dh] in
    out_dtype (bf16, or f32 for a merge that quantizes it to int8 and for
    the stand-alone attention), the layout the merge projection takes.
    On the card: csrc/masked_attention.cu with ``attention_plan``."""
    if exporting():
        return _ops().masked_attention(q, k, v, key_pad, drop, inv_keep,
                                       out_dtype=out_dtype)
    if not on_cuda(q):
        return masked_attention_plain(q, k, v, key_pad, drop, inv_keep,
                                      out_dtype)
    name = "masked_attention"
    drop, keep = _keep_args(name, drop)
    _same_device(name, q, k, v, key_pad, drop)
    B, H, Lq, Lk, Dh, pad = _check_attention(name, q, k, v, key_pad, drop,
                                             (BF16, F32))
    _require(out_dtype in (BF16, F32), f"{name}: out_dtype {out_dtype}")
    out = torch.empty((B, Lq, H * Dh), dtype=out_dtype, device=q.device)
    plan = attention_plan(B, H, Lq, Lk, Dh)
    rc = _lib().mcan_masked_attention(
        q.data_ptr(), int(q.dtype == F32), q.stride(0), q.stride(1),
        q.stride(2), k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1),
        k.stride(2), int(k.dtype == F32), pad.data_ptr(), _ptr(drop),
        float(inv_keep), *keep, out.data_ptr(), int(out_dtype == F32),
        Lq * H * Dh, H * Dh, B, H, Lq, Lk, Dh, 1.0 / Dh ** 0.5,
        plan.instance, plan.dhp, plan.kc, plan.rows, plan.grid, plan.threads,
        plan.smem, _stream(q))
    _check(rc, name if out_dtype == BF16 else name + "_f32")
    return out


def masked_attention_bwd_plain(q, k, v, key_pad, dout, dq, dk, dv,
                               dq16=None, dk16=None, dv16=None, drop=None,
                               inv_keep: float = 1.0) -> None:
    drop = _attention_keep(drop, q, k)
    B, H, Lq, Dh = q.shape
    scale = 1.0 / Dh ** 0.5
    qb, kb, vb = (t.to(BF16).float() for t in (q, k, v))
    do = dout.reshape(B, Lq, H, Dh).transpose(1, 2).to(BF16).float()
    p = _probs(q, k, key_pad)
    pd = _drop(p, drop, inv_keep).to(BF16).float()
    g = _drop(do @ vb.transpose(-1, -2), drop, inv_keep)
    ds = (p * (g - (p * g).sum(-1, keepdim=True))).to(BF16).float()
    for out, out16, val in ((dq, dq16, ds @ kb * scale),
                            (dk, dk16, ds.transpose(-1, -2) @ qb * scale),
                            (dv, dv16, pd.transpose(-1, -2) @ do)):
        out.copy_(val)
        if out16 is not None:
            out16.copy_(val)


def masked_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_pad: torch.Tensor, dout: torch.Tensor,
                         dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                         dq16: Optional[torch.Tensor] = None,
                         dk16: Optional[torch.Tensor] = None,
                         dv16: Optional[torch.Tensor] = None,
                         drop: Keep = None,
                         inv_keep: float = 1.0) -> None:
    """Gradients of ``masked_attention(q, k, v, key_pad, drop, inv_keep)``
    for the upstream gradient dout [B, Lq, H*Dh] bf16, written in place:
    dq [B, H, Lq, Dh], dk / dv [B, H, Lk, Dh], f32, strided views whose
    last dim is contiguous; dq16 / dk16 / dv16 optional bf16 copies with
    their f32 twin's strides. The probabilities are recomputed from q, k
    and the pad mask; dS = P * (drop(dP) - rowsum(P * drop(dP))). A
    Philox drop regenerates the forward's mask. On the card:
    csrc/masked_attention_bwd.cu with ``attention_bwd_plan``."""
    if not on_cuda(q):
        return masked_attention_bwd_plain(q, k, v, key_pad, dout, dq, dk, dv,
                                          dq16, dk16, dv16, drop, inv_keep)
    name = "masked_attention_bwd"
    drop, keep = _keep_args(name, drop)
    _same_device(name, q, k, v, key_pad, dout, dq, dk, dv, dq16, dk16, dv16,
                 drop)
    B, H, Lq, Lk, Dh, pad = _check_attention(name, q, k, v, key_pad, drop)
    _require(dout.shape == (B, Lq, H * Dh) and dout.dtype == BF16
             and dout.stride(2) == 1,
             f"{name}: dout must be bf16 [{B}, {Lq}, {H * Dh}] with a "
             f"contiguous last dim")
    for t, t16, L in ((dq, dq16, Lq), (dk, dk16, Lk), (dv, dv16, Lk)):
        _require(t.shape == (B, H, L, Dh) and t.dtype == F32
                 and t.stride(3) == 1,
                 f"{name}: gradient outputs must be f32 [{B}, {H}, L, {Dh}] "
                 f"with a contiguous last dim")
        _require(t16 is None or (t16.dtype == BF16
                                 and t16.shape == t.shape
                                 and t16.stride() == t.stride()),
                 f"{name}: a bf16 copy must share its f32 twin's strides")
    plan = attention_bwd_plan(B, H, Lq, Lk, Dh)
    # the long kernels' per-row max, sum, rowsum(P * drop(dPd)), 1 / sum
    stats = torch.empty((B, H, Lq, 4), dtype=F32, device=q.device) \
        if plan.stats else None
    rc = _lib().mcan_masked_attention_bwd(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        int(k.dtype == F32), pad.data_ptr(), _ptr(drop), float(inv_keep),
        *keep, dout.data_ptr(), dout.stride(0), dout.stride(1),
        dq.data_ptr(), _ptr(dq16), dq.stride(0), dq.stride(1), dq.stride(2),
        dk.data_ptr(), _ptr(dk16), dk.stride(0), dk.stride(1), dk.stride(2),
        dv.data_ptr(), _ptr(dv16), dv.stride(0), dv.stride(1), dv.stride(2),
        _ptr(stats), B, H, Lq, Lk, Dh, 1.0 / Dh ** 0.5, plan.instance,
        plan.dhp, plan.kc, plan.rows, plan.grid, plan.threads, plan.smem,
        plan.key_rows, plan.key_grid, plan.key_threads, plan.key_smem,
        _stream(q))
    _check(rc, name)


# ---------------------------------------------------------------------------
# residual_layernorm and its backward
# ---------------------------------------------------------------------------

def _rows_mask(mask: Keep, res: torch.Tensor) -> Optional[torch.Tensor]:
    """A Philox keep source of a LayerNorm's rows as its keep-mask."""
    if not isinstance(mask, Philox):
        return mask
    D = res.shape[-1]
    return _rows_keep(mask, res.numel() // D, D, res.device).reshape(
        res.shape)


def _residual(res, y, bias, mask, inv_keep):
    mask = _rows_mask(mask, res)
    r = res.float()
    if y is None:
        return r
    t = y if bias is None else y + bias
    return r + _drop(t, mask, inv_keep)


def _check_ln_width(name: str, D: int) -> None:
    _require(D % 32 == 0 and 32 <= D <= LN_MAX_WIDTH,
             f"{name}: D={D} must be a multiple of 32 up to {LN_MAX_WIDTH}")


def residual_layernorm_plain(res: torch.Tensor, y: torch.Tensor,
                             bias: Optional[torch.Tensor],
                             gamma: torch.Tensor, beta: torch.Tensor,
                             out_dtypes: Sequence[torch.dtype] = (F32,), *,
                             mask: Keep = None,
                             inv_keep: float = 1.0, save_r: bool = False,
                             reciprocal: bool = False, r_dtype=F32
                             ) -> Tuple[torch.Tensor, ...]:
    r = _residual(res, y, bias, mask, inv_keep)
    out = std_layer_norm(r, gamma, beta, LN_EPS, reciprocal)
    return tuple(out.to(dt) for dt in out_dtypes) + \
        ((r.to(r_dtype),) if save_r else ())


def residual_layernorm(res: torch.Tensor, y: torch.Tensor,
                       bias: Optional[torch.Tensor], gamma: torch.Tensor,
                       beta: torch.Tensor,
                       out_dtypes: Sequence[torch.dtype] = (F32,), *,
                       mask: Keep = None,
                       inv_keep: float = 1.0, save_r: bool = False,
                       reciprocal: bool = False, r_dtype=F32
                       ) -> Tuple[torch.Tensor, ...]:
    """LN(r) over the last dim, r = res + drop(y + bias), all in f32.
    res [..., D] bf16 or f32, y [..., D] f32, bias/gamma/beta [D] f32 (bias
    may be None), mask an optional keep-mask shaped like y or its Philox
    source (rows per sample in its ``rows``), D a multiple of 32 up to
    2048. Returns one
    tensor per entry of out_dtypes (each f32 or bf16), shaped like res,
    then r (in r_dtype, f32 or bf16) when save_r. reciprocal: the train
    kernels' rounding (``std_layer_norm``)."""
    if exporting():
        return _ops().residual_layernorm(
            res, y, bias, gamma, beta, out_dtypes, mask=mask,
            inv_keep=inv_keep, save_r=save_r, reciprocal=reciprocal,
            r_dtype=r_dtype)
    if not on_cuda(res):
        return residual_layernorm_plain(res, y, bias, gamma, beta, out_dtypes,
                                        mask=mask, inv_keep=inv_keep,
                                        save_r=save_r, reciprocal=reciprocal,
                                        r_dtype=r_dtype)
    name = "residual_layernorm"
    D = res.shape[-1]
    rows = res.numel() // D
    mask, keep = _keep_args(name, mask, rows)
    _same_device(name, res, y, bias, gamma, beta, mask)
    _check_ln_width(name, D)
    _require(y.shape == res.shape and y.dtype == F32,
             f"{name}: y must be f32 shaped like res {tuple(res.shape)}")
    _require(res.dtype in (BF16, F32), f"{name}: res dtype {res.dtype}")
    _require(res.is_contiguous() and y.is_contiguous(),
             f"{name}: res and y must be contiguous")
    for t in (bias, gamma, beta):
        _check_vec(name, t, D)
    _check_mask(name, mask, res.shape)
    _require(len(out_dtypes) > 0 and set(out_dtypes) <= {F32, BF16}
             and len(set(out_dtypes)) == len(out_dtypes),
             f"{name}: out_dtypes {out_dtypes}")
    _require(r_dtype in (F32, BF16), f"{name}: r_dtype {r_dtype}")
    outs = {dt: torch.empty(res.shape, dtype=dt, device=res.device)
            for dt in out_dtypes}
    r = torch.empty(res.shape, dtype=r_dtype, device=res.device) \
        if save_r else None
    r32, r16 = (r, None) if r_dtype == F32 else (None, r)
    rc = _lib().mcan_residual_layernorm(
        res.data_ptr(), int(res.dtype == BF16), y.data_ptr(), _ptr(bias),
        _ptr(mask), float(inv_keep), *keep, gamma.data_ptr(), beta.data_ptr(),
        _ptr(outs.get(F32)), _ptr(outs.get(BF16)), _ptr(r32), _ptr(r16),
        rows, D, LN_EPS, int(reciprocal), _stream(res))
    _check(rc, name)
    return tuple(outs[dt] for dt in out_dtypes) + ((r,) if save_r else ())


def residual_layernorm_bwd_plain(g, res, y, bias, gamma, *, mask=None,
                                 inv_keep: float = 1.0,
                                 dy_dtypes: Sequence[torch.dtype] = (F32,)
                                 ) -> Tuple[torch.Tensor, ...]:
    mask = _rows_mask(mask, res)
    r = _residual(res, y, bias, mask, inv_keep)
    g = g.float()
    D = r.shape[-1]
    c = r - r.mean(-1, keepdim=True)
    std = ((c * c).sum(-1, keepdim=True) / (D - 1)).sqrt()
    inv = 1.0 / (std + LN_EPS)
    sg = gamma * g
    dstd = -(sg * c).sum(-1, keepdim=True) * (inv * inv)
    dc = sg * inv + c * (dstd / ((D - 1) * std))
    dr = dc - dc.mean(-1, keepdim=True)
    dy = _drop(dr, mask, inv_keep)
    return (dr, g * (c * inv)) + tuple(dy.to(dt) for dt in dy_dtypes)


def residual_layernorm_bwd(g: torch.Tensor, res: torch.Tensor,
                           y: Optional[torch.Tensor],
                           bias: Optional[torch.Tensor], gamma: torch.Tensor,
                           *, mask: Keep = None,
                           inv_keep: float = 1.0,
                           dy_dtypes: Sequence[torch.dtype] = (F32,)
                           ) -> Tuple[torch.Tensor, ...]:
    """The backward of ``residual_layernorm`` for the output gradient g
    (the Bessel-std LN backward of sga_train.py::_ln_bwd_u :122-142).
    g, res [rows, D] f32 or bf16 (a bf16 save is read as saved), y f32 or
    None (then r = res), bias / gamma [D]. r and the normalised u are
    recomputed from res, y and bias, never from the LN output. Returns
    (dr, g * u, then drop(dr) once per dy_dtypes), all f32 but the dy
    entries."""
    if not on_cuda(g):
        return residual_layernorm_bwd_plain(g, res, y, bias, gamma,
                                            mask=mask, inv_keep=inv_keep,
                                            dy_dtypes=dy_dtypes)
    name = "residual_layernorm_bwd"
    D = res.shape[-1]
    rows = res.numel() // D
    mask, keep = _keep_args(name, mask, rows)
    _same_device(name, g, res, y, bias, gamma, mask)
    _check_ln_width(name, D)
    for t, dtypes in ((g, (F32, BF16)), (res, (F32, BF16)), (y, (F32,))):
        _require(t is None or (t.shape == res.shape and t.dtype in dtypes
                               and t.is_contiguous()),
                 f"{name}: g, res (f32 or bf16) and y (f32) must be "
                 f"contiguous, shaped {tuple(res.shape)}")
    _check_vec(name, bias, D)
    _check_vec(name, gamma, D)
    _check_mask(name, mask, res.shape)
    _require(set(dy_dtypes) <= {F32, BF16}
             and len(set(dy_dtypes)) == len(dy_dtypes),
             f"{name}: dy_dtypes {dy_dtypes}")
    dr = torch.empty(res.shape, dtype=F32, device=res.device)
    gu = torch.empty(res.shape, dtype=F32, device=res.device)
    dys = {dt: torch.empty(res.shape, dtype=dt, device=res.device)
           for dt in dy_dtypes}
    rc = _lib().mcan_residual_layernorm_bwd(
        g.data_ptr(), int(g.dtype == BF16), res.data_ptr(),
        int(res.dtype == BF16), _ptr(y), _ptr(bias), _ptr(mask),
        float(inv_keep), *keep, gamma.data_ptr(), dr.data_ptr(),
        _ptr(dys.get(F32)), _ptr(dys.get(BF16)), gu.data_ptr(), rows, D,
        LN_EPS, _stream(g))
    _check(rc, name)
    return (dr, gu) + tuple(dys[dt] for dt in dy_dtypes)


# ---------------------------------------------------------------------------
# col_sum
# ---------------------------------------------------------------------------

def col_sum_plain(mats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [m.float().sum(dim=0) for m in mats]


COL_SUM_CHUNK = 128      # col_sum.cu's columns a chunk
COL_SUM_ITEMS = 4 * GEMM_SMS   # the blocks the SMs hold at once (4 an SM)
COL_SUM_MIN_ROWS = 64    # rows a slab takes at least (4 rows in flight for
#                          each of up to 16 row groups)


@dataclass(frozen=True)
class ColSumPlan:
    """How col_sum.cu covers one launch: each matrix's columns in chunks of
    ``chunk``, the rows in ``slabs`` slabs (``slab_range``), one block per
    (chunk, slab); with more than one slab the partials go through a
    workspace and the last block of a chunk adds them in slab order."""
    rows: int
    chunk: int
    chunks: Tuple[int, ...]    # per matrix
    slabs: int

    @property
    def total_chunks(self) -> int:
        return sum(self.chunks)

    @property
    def grid(self) -> int:
        return self.total_chunks * self.slabs

    def slab_range(self, s: int) -> Tuple[int, int]:
        return (s * self.rows // self.slabs, (s + 1) * self.rows // self.slabs)

    @property
    def workspace_bytes(self) -> int:
        """The f32 partials of every slab of every chunk (none in one
        slab)."""
        return 0 if self.slabs == 1 else \
            self.total_chunks * self.slabs * self.chunk * 4


@functools.lru_cache(maxsize=1024)
def col_sum_plan(rows: int, cols: Tuple[int, ...]) -> ColSumPlan:
    """The plan of column sums of matrices of ``rows`` rows and widths
    ``cols``, from the shapes alone (so that a shape always sums in the
    same order): chunks of 128 columns, and as many row slabs as the SMs
    hold blocks at once (four an SM: a block more would run alone after
    the rest), each slab at least 64 rows."""
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    chunks = tuple(cdiv(c, COL_SUM_CHUNK) for c in cols)
    slabs = max(1, min(COL_SUM_ITEMS // max(sum(chunks), 1),
                       rows // COL_SUM_MIN_ROWS))
    return ColSumPlan(rows, COL_SUM_CHUNK, chunks, slabs)


def col_sum(mats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Column sums of one to four f32 or bf16 [rows, cols_i] matrices with
    the same number of rows -> f32 [cols_i] each, in one launch over the
    whole card (``col_sum_plan``), summed in f32 in an order the shapes
    fix (the same bits on every run)."""
    if not on_cuda(mats[0]):
        return col_sum_plain(mats)
    name = "col_sum"
    _same_device(name, *mats)
    n, rows = len(mats), mats[0].shape[0]
    _require(1 <= n <= MAX_COL_SUMS and rows > 0,
             f"{name}: 1 to {MAX_COL_SUMS} matrices with rows, got {n}")
    for m in mats:
        _require(m.dim() == 2 and m.shape[0] == rows
                 and m.dtype in (F32, BF16) and m.stride(1) == 1,
                 f"{name}: f32 or bf16 [rows, cols] matrices with {rows} "
                 f"rows and unit column stride")
    dev = mats[0].device
    plan = col_sum_plan(rows, tuple(m.shape[1] for m in mats))
    outs = [torch.empty(m.shape[1], dtype=F32, device=dev) for m in mats]
    ws = counters = None
    if plan.slabs > 1:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=F32, device=dev)
        counters = _zeroed_counters(_COL_SUM_COUNTERS, dev,
                                    plan.total_chunks,
                                    "col_sum: the chunk counters")
    arrays = ((ctypes.c_void_p * n)(*[m.data_ptr() for m in mats]),
              (ctypes.c_int * n)(*[int(m.dtype == BF16) for m in mats]),
              (ctypes.c_longlong * n)(*[m.stride(0) for m in mats]),
              (ctypes.c_int * n)(*[m.shape[1] for m in mats]),
              (ctypes.c_void_p * n)(*[t.data_ptr() for t in outs]))
    rc = _lib().mcan_col_sum(
        n, *(ctypes.cast(a, ctypes.c_void_p) for a in arrays), rows,
        plan.slabs, _ptr(ws), _ptr(counters), _stream(mats[0]))
    _check(rc, name)
    return outs


# ---------------------------------------------------------------------------
# attflat_pool
# ---------------------------------------------------------------------------

ATTFLAT_THREADS = 256      # attflat_pool.cu: 8 warps a CTA
ATTFLAT_MAX_RANKS = 8      # CTAs a sample: one cluster, the portable size
ATTFLAT_MIN_CHUNK = 64     # columns a rank pools at the least
# logit rows a rank computes at the least: below it the cluster barrier and
# the logits' gather outweigh the rows and columns a rank sheds (on the card
# MCAN-small's 14-row language AttFlat at B = 64 ran slower at 4 ranks than
# at 2, and than one block a sample)
ATTFLAT_MIN_ROWS = 6


def attflat_smem_bytes(L: int, G: int) -> int:
    """attflat_pool.cu's dynamic shared memory (attflat::smem_bytes): the
    logits and the weights [L, G] f32, then 8 floats a thread of pooling
    partials."""
    return (2 * L * G + ATTFLAT_THREADS * 8) * 4


@dataclass(frozen=True)
class AttflatPlan:
    """How attflat_pool.cu covers one call (``attflat_plan``): a cluster of
    ``ranks`` CTAs a sample; rank r computes the logits of rows r, r +
    ranks, ... and pools ``columns(r)`` of every glimpse."""
    B: int
    L: int
    G: int
    D: int
    ranks: int
    chunk: int
    smem: int

    @property
    def grid(self) -> int:
        return self.B * self.ranks

    def columns(self, rank: int) -> Tuple[int, int]:
        return rank * self.chunk, min(self.D, (rank + 1) * self.chunk)

    def logit_rows(self, rank: int) -> Tuple[int, ...]:
        return tuple(range(rank, self.L, self.ranks))


@functools.lru_cache(maxsize=1024)
def attflat_plan(B: int, L: int, G: int, D: int) -> AttflatPlan:
    """The plan of one attflat_pool call from the shape alone: the fewest
    CTAs a sample, of 1, 2, 4 and 8, whose B x ranks CTAs cover the card's
    SMs (8 where none does: B = 1 and 8), no more than leave each rank
    ``ATTFLAT_MIN_CHUNK`` columns to pool and ``ATTFLAT_MIN_ROWS`` logit
    rows to compute; the columns dealt in chunks of a multiple of 8 (whole
    16-byte units of a bf16 row), the last rank what is left. MCAN-small
    at B = 64: 4 CTAs a sample for the image (60 rows), 2 for the language
    (14 rows)."""
    _require(B >= 0 and L >= 1 and G >= 1 and D >= 1
             and L * G <= ATTFLAT_MAX_LOGITS,
             f"attflat_plan: L x G = {L * G} must be at most "
             f"{ATTFLAT_MAX_LOGITS} (B={B}, D={D})")
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    ranks = next((r for r in (1, 2, 4) if B * r >= GEMM_SMS),
                 ATTFLAT_MAX_RANKS)
    ranks = max(1, min(ranks, D // ATTFLAT_MIN_CHUNK, L // ATTFLAT_MIN_ROWS))
    chunk = cdiv(cdiv(D, ranks), 8) * 8
    return AttflatPlan(B, L, G, D, cdiv(D, chunk), chunk,
                       attflat_smem_bytes(L, G))


def attflat_pool_plain(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       mask: torch.Tensor, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, L, D = x.shape
    logits = bf16_matmul(h, w2).view(B, L, -1) + b2
    logits = logits + mask[:, 0, 0, :, None].float() * NEG_INF
    att = torch.softmax(logits, dim=1)
    pooled = att.to(BF16).float().transpose(1, 2) @ x.to(BF16).float()
    return pooled.reshape(B, -1).to(BF16), att


def attflat_pool(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 mask: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The middle of AttFlat (``_attflat_kernel``, mcan_vqa_tpu/ops/
    attflat.py:27): h [B*L, Fm] bf16 (the MLP's ReLU hidden), w2 [Fm, G]
    bf16, b2 [G] f32, mask bool [B, 1, 1, L] (True = PAD), x [B, L, D] f32
    or bf16 -> (pooled [B, G*D] bf16, att [B, L, G] f32): logits = h . w2 +
    b2 + PAD * -1e9 (summed in f32), att the softmax over L in f32, pooled
    = bf16(att)^T . bf16(x) summed in f32 and rounded to bf16. On the card,
    ``attflat_plan``'s clusters of CTAs a sample."""
    if exporting():
        return _ops().attflat_pool(h, w2, b2, mask, x)
    if not on_cuda(x):
        return attflat_pool_plain(h, w2, b2, mask, x)
    name = "attflat_pool"
    _same_device(name, h, w2, b2, mask, x)
    _require(x.dim() == 3 and x.dtype in (F32, BF16) and x.is_contiguous(),
             f"{name}: x must be a contiguous f32 or bf16 [B, L, D]")
    B, L, D = x.shape
    Fm, G = w2.shape
    _require(h.dtype == BF16 and tuple(h.shape) == (B * L, Fm)
             and h.stride(1) == 1 and w2.dtype == BF16
             and w2.is_contiguous(),
             f"{name}: h must be bf16 [{B * L}, {Fm}] with unit column "
             f"stride and w2 contiguous bf16 [{Fm}, {G}]")
    _check_vec(name, b2, G)
    _require(mask.shape == (B, 1, 1, L) and mask.dtype == torch.bool
             and mask.is_contiguous(),
             f"{name}: mask must be contiguous bool [{B}, 1, 1, {L}]")
    _require(1 <= L * G <= ATTFLAT_MAX_LOGITS,
             f"{name}: L x G = {L * G} must be at most {ATTFLAT_MAX_LOGITS}")
    plan = attflat_plan(B, L, G, D)
    pooled = torch.empty((B, G * D), dtype=BF16, device=x.device)
    att = torch.empty((B, L, G), dtype=F32, device=x.device)
    rc = _lib().mcan_attflat_pool(
        h.data_ptr(), h.stride(0), w2.data_ptr(), b2.data_ptr(),
        mask.data_ptr(), x.data_ptr(), int(x.dtype == F32),
        pooled.data_ptr(), att.data_ptr(), B, L, Fm, G, D, plan.ranks,
        plan.chunk, plan.smem, _stream(x))
    _check(rc, name)
    return pooled, att


# ---------------------------------------------------------------------------
# the all-layer stacks: sga_decoder, sa_encoder (one cooperative launch)
# ---------------------------------------------------------------------------

# the stacked weights in the order of the C functions' arrays
DECODER_WEIGHTS = ("wqkv1", "bqkv1", "wm1", "bm1", "ln1_s", "ln1_b", "wkv2",
                   "bkv2", "wq2", "bq2", "wm2", "bm2", "ln2_s", "ln2_b", "w1",
                   "b1", "w2", "b2", "ln3_s", "ln3_b")
ENCODER_WEIGHTS = ("wqkv", "bqkv", "wm", "bm", "ln1_s", "ln1_b", "w1", "b1",
                   "w2", "b2", "ln2_s", "ln2_b")
COOPERATIVE_LAUNCH_TOO_LARGE = 720   # cudaErrorCooperativeLaunchTooLarge
# each wrapper's last launch: (grid, blocks per SM, SMs, shared memory bytes)
LAST_GRID: Dict[str, Tuple[int, int, int, int]] = {}
# persistent_stages.cuh: a block of two consumer warpgroups and a producer
# warp; a ring of six K-tile slots of 32 KB (A: two 64-row boxes, W: two
# 64-column boxes), which the attention items stage in too; LayerNorm rows
# one to a warp
STACK_TILES = ((128, 128), (128, 64), (64, 128))
STACK_SLOT = 2 * 128 * GEMM_BK * 2
STACK_RING = 6 * STACK_SLOT
STACK_SMEM = 1024 + STACK_RING + 16 * 6 + 16
STACK_WARPS = 9
STACK_CONSUMERS = 256  # the two consumer warpgroups
STACK_MAX_SPLITS = 2   # the last block of a split tile reads every split's
#                        partial after a chain of round trips (partial
#                        stores, fence, counter): on the card 2 splits beat
#                        1, 4 and 8 at B = 1 and came within 3% of 1 at B = 8
#                        (PERF.md §6)


@dataclass(frozen=True)
class StackGemm:
    """One product of an all-layer stack's GEMM stage: output tiles of
    ``bm`` x ``bn``, K in ``k_tiles`` tiles of 64 split over ``splits``
    blocks per tile (split s sums ``split_range(s)``); a split product's f32
    partials at float ``ws`` of the workspace and its tile counters at
    ``cnt``."""
    M: int
    N: int
    K: int
    bm: int
    bn: int
    splits: int
    ws: int = 0
    cnt: int = 0

    @property
    def tiles_m(self) -> int:
        return -(-self.M // self.bm)

    @property
    def tiles_n(self) -> int:
        return -(-self.N // self.bn)

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def k_tiles(self) -> int:
        return -(-self.K // GEMM_BK)

    @property
    def items(self) -> int:
        return self.tiles * self.splits

    def split_range(self, s: int) -> Tuple[int, int]:
        return (s * self.k_tiles // self.splits,
                (s + 1) * self.k_tiles // self.splits)

    @property
    def ws_floats(self) -> int:
        """The f32 partials of every split of every tile (none unsplit)."""
        return 0 if self.splits == 1 else \
            self.splits * self.tiles * self.bm * self.bn

    @property
    def counters(self) -> int:
        return 0 if self.splits == 1 else self.tiles


def _stack_gemm(M: int, N: int, K: int) -> StackGemm:
    """A stage's product from its shape: 64 x 128 tiles where the rows fit
    one 64-row tile; else 128 x 128 where its tiles reach half the SMs, then
    128 x 64, else whichever of 128 x 64 and 64 x 128 gives more tiles (128
    x 64 on a tie). Where the tiles still leave more than half the SMs idle
    (a weight-bound product at B = 1 or 8), K splits over as many blocks as
    bring the items to at most one wave, at most STACK_MAX_SPLITS and one
    K-tile each."""
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    tiles = lambda t: cdiv(M, t[0]) * cdiv(N, t[1])     # noqa: E731
    if M <= 64:
        bm, bn = 64, 128
    else:
        bm, bn = next((t for t in STACK_TILES[:2]
                       if tiles(t) >= GEMM_SMS // 2),
                      max(STACK_TILES[1:], key=tiles))
    t = cdiv(M, bm) * cdiv(N, bn)
    splits = 1
    if t < GEMM_SMS // 2:
        splits = max(1, min(GEMM_SMS // t, cdiv(K, GEMM_BK),
                            STACK_MAX_SPLITS))
    return StackGemm(M, N, K, bm, bn, splits)


def _stack_attention(B: int, H: int, Lq: int, Lk: int,
                     Dh: int) -> AttentionPlan:
    """An attention stage's plan: masked_attention.cu's (``attention_plan``:
    instance, rows, tiles), its head width padded to one of the four
    instances the stacks hold -- one-block <64, 64 keys> or <128, 128 keys>,
    long <128> or <256> -- whose zero columns and keys change no sum, so
    each row is the one that kernel computes."""
    p = attention_plan(B, H, Lq, Lk, Dh)
    if p.instance == 0:
        dhp, kc = (64, 64) if p.dhp <= 64 and p.kc == 64 else (128, 128)
        staged = 2 * 16 * (-(-Lk // 16))
    else:
        dhp, kc = (128 if p.dhp <= 128 else 256), p.kc
        staged = 2 * 16 * (-(-Lk // 16)) if Lk <= ATT_LONG_KC \
            else 4 * ATT_LONG_KC
    return dataclasses.replace(p, dhp=dhp, kc=kc,
                               smem=(p.rows + staged) * (dhp + 8) * 2)


@dataclass(frozen=True)
class StackPlan:
    """How an all-layer stack covers one call (``stack_plan``): its
    products in the C function's order (decoder: qkv1, m1, q2, kv2, m2, w1,
    w2 -- kv2 None with external k/v; encoder: qkv, m, w1, w2), each
    stage's ``stages`` grouping of them, the attention stages' plans
    (decoder: self, cross; encoder: self), ``items`` (the largest stage's
    work items: the grid's cap), the workspace and counters the split
    products share. ``att_groups``: the attention items a block runs at
    once, each on a group of its consumer warps and a slice of the ring."""
    gemms: Tuple[Optional[StackGemm], ...]
    stages: Tuple[Tuple[int, ...], ...]
    attention: Tuple[AttentionPlan, ...]
    att_groups: Tuple[int, ...]
    items: int
    workspace_floats: int
    counters: int
    smem: int = STACK_SMEM

    def fields(self) -> Tuple[int, ...]:
        """The int array the C functions take: per product bm, bn, splits,
        ws, cnt (zeros for an absent one); per attention instance, dhp,
        kc, rows, groups; then items."""
        out: List[int] = []
        for g in self.gemms:
            out += [0] * 5 if g is None else [g.bm, g.bn, g.splits, g.ws,
                                              g.cnt]
        for a, n in zip(self.attention, self.att_groups):
            out += [a.instance, a.dhp, a.kc, a.rows, n]
        return tuple(out + [self.items])


@functools.lru_cache(maxsize=1024)
def stack_plan(B: int, Lx: int, D: int, F: int, H: int, Lq: int = 0,
               kv: str = "") -> StackPlan:
    """The plan of one all-layer call from the shape alone (never from the
    grid the launch gets, so any grid gives the same bits): kv "" is the
    encoder over Lx tokens; "in" / "ext" the decoder over Lx regions with
    Lq question keys, its cross k/v projected in the kernel or given. Each
    product by ``_stack_gemm``; the attention by ``_stack_attention``; the
    products of one stage (the decoder's cross query and in-kernel k/v)
    take consecutive workspace and counters, and every stage starts both
    at 0 (a grid barrier lies between stages)."""
    _require(kv in ("", "in", "ext"), f"stack_plan: kv {kv!r}")
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    M, Dh = B * Lx, D // H
    g = _stack_gemm
    if kv:
        gemms = [g(M, 3 * D, D), g(M, D, D), g(M, D, D),
                 g(B * Lq, 2 * D, D) if kv == "in" else None, g(M, D, D),
                 g(M, F, D), g(M, D, F)]
        stages = ((0,), (1,), (2, 3) if kv == "in" else (2,), (4,), (5,),
                  (6,))
        att = (_stack_attention(B, H, Lx, Lx, Dh),
               _stack_attention(B, H, Lx, Lq, Dh))
    else:
        gemms = [g(M, 3 * D, D), g(M, D, D), g(M, F, D), g(M, D, F)]
        stages = ((0,), (1,), (2,), (3,))
        att = (_stack_attention(B, H, Lx, Lx, Dh),)
    ws = counters = 0
    for stage in stages:
        w = c = 0
        for i in stage:
            gemms[i] = dataclasses.replace(gemms[i], ws=w, cnt=c)
            w += gemms[i].ws_floats
            c += gemms[i].counters
        ws, counters = max(ws, w), max(counters, c)
    items = max([sum(gemms[i].items for i in st) for st in stages]
                + [B * H * a.tiles for a in att] + [cdiv(M, STACK_WARPS)])
    # as many items at once as the consumer warps and the ring hold
    groups = tuple(next(n for n in (8, 4, 2, 1)
                        if n * a.threads <= STACK_CONSUMERS
                        and n * a.smem <= STACK_RING) for a in att)
    return StackPlan(tuple(gemms), stages, att, groups, items, ws, counters)


_STACK_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _stack_counters(device: torch.device, n: int) -> torch.Tensor:
    """The split products' tile counters of the all-layer stacks."""
    return _zeroed_counters(_STACK_COUNTERS, device, n,
                            "the all-layer stacks' split-K counters")


def _layer(wp, l: int) -> Dict[str, torch.Tensor]:
    return {k: t[l] for k, t in wp.items()}


def sga_decoder_plain(v: torch.Tensor, v_mask: torch.Tensor,
                      q_mask: torch.Tensor, wp, *, num_heads: int,
                      q: Optional[torch.Tensor] = None,
                      kq: Optional[torch.Tensor] = None,
                      vq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Layer by layer through the per-block plain composition
    (ops/sga_block.py), the stream f32 between the layers."""
    from mcan_vqa_tpu_torch.ops.sga_block import fused_sga_block_plain
    B, _, D = v.shape
    H = num_heads
    x = v.float()
    for l in range(wp["w1"].shape[0]):
        p = _layer(wp, l)
        if q is not None:   # the cross k/v from the bf16 encoder output
            kv = gemm_bias_act_plain(q.reshape(-1, D).to(BF16), p["wkv2"],
                                     p["bkv2"], out_dtype=BF16)
            k_l, v_l = (split_heads(t, H)
                        for t in kv.view(B, -1, 2 * D).chunk(2, dim=-1))
        else:
            k_l, v_l = kq[:, l * H:(l + 1) * H], vq[:, l * H:(l + 1) * H]
        p.update(wm1_full=p["wm1"], wq2_full=p["wq2"], bq2_full=p["bq2"],
                 wm2_full=p["wm2"])
        x = fused_sga_block_plain(x, k_l, v_l, v_mask, q_mask, p,
                                  num_heads=H)
    return x.to(v.dtype)


def sa_encoder_plain(x: torch.Tensor, x_mask: torch.Tensor, wp, *,
                     num_heads: int) -> torch.Tensor:
    """Layer by layer through the per-block plain composition, the stream
    f32 between the layers."""
    from mcan_vqa_tpu_torch.ops.sga_block import fused_sa_block_plain
    h = x.float()
    for l in range(wp["w1"].shape[0]):
        h = fused_sa_block_plain(h, x_mask, _layer(wp, l),
                                 num_heads=num_heads)
    return h.to(x.dtype)


def _check_stack(name: str, wp, names, shapes) -> List[Optional[int]]:
    """Each stacked weight contiguous, bf16 for a matrix and f32 for a
    vector, of its shape -> the pointers, in the C function's order (None
    where the name is absent from shapes)."""
    ptrs = []
    for n in names:
        if n not in shapes:
            ptrs.append(None)
            continue
        t = wp[n]
        want = BF16 if len(shapes[n]) == 3 else F32
        _require(tuple(t.shape) == shapes[n] and t.dtype == want
                 and t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{name}: {n} must be contiguous {want} {shapes[n]}, "
                 f"16-byte aligned, got {tuple(t.shape)} {t.dtype}")
        ptrs.append(t.data_ptr())
    return ptrs


def _check_pad(name: str, mask: torch.Tensor, B: int, L: int) -> None:
    _require(mask.shape == (B, 1, 1, L) and mask.dtype == torch.bool
             and mask.is_contiguous(),
             f"{name}: mask must be contiguous bool [{B}, 1, 1, {L}]")


def _scratch(device, sizes: Sequence[int]):
    """One byte buffer cut into 256-byte aligned pieces of the given sizes
    -> (the buffer, a ctypes array of the pieces' addresses, None for 0)."""
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 256) * 256
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, (ctypes.c_void_p * len(sizes))(
        *[base + o if n else None for o, n in zip(offs, sizes)])


def _stack_plan_args(device, plan: StackPlan, workspace):
    """The C functions' plan, workspace and counters arguments: the plan's
    int fields (a ctypes array, which the call passes by address and keeps
    alive), the workspace piece of the scratch buffer and the device's
    counters where a product splits (else null)."""
    fields = plan.fields()
    counters = _stack_counters(device, plan.counters) if plan.counters \
        else None
    return ((ctypes.c_int * len(fields))(*fields),
            workspace if plan.counters else None, _ptr(counters))


def _launch_stack(name: str, fn, args, info) -> None:
    rc = fn(*args)
    if rc == COOPERATIVE_LAUNCH_TOO_LARGE:
        raise RuntimeError(f"{name}: the grid does not fit the card "
                           f"co-resident (cudaErrorCooperativeLaunchTooLarge)")
    _check(rc, name)
    LAST_GRID[name] = tuple(info)


def _stack_dims(name: str, x: torch.Tensor, wp, num_heads: int):
    _require(x.dim() == 3 and x.dtype in (BF16, F32) and x.is_contiguous(),
             f"{name}: the stream must be a contiguous bf16 or f32 [B, L, D]")
    B, Lx, D = x.shape
    L, _, F = wp["w1"].shape
    H = num_heads
    _require(D % H == 0 and D // H <= MAX_HEAD_DIM and D % GEMM_ALIGN == 0
             and F % GEMM_ALIGN == 0 and B >= 1 and Lx >= 1 and L >= 1,
             f"{name}: needs D, F multiples of {GEMM_ALIGN}, D / H <= "
             f"{MAX_HEAD_DIM} and a non-empty batch; got B={B}, L={Lx}, "
             f"D={D}, F={F}, H={H}")
    return B, Lx, D, F, H, L


def sga_decoder(v: torch.Tensor, v_mask: torch.Tensor, q_mask: torch.Tensor,
                wp, *, num_heads: int, q: Optional[torch.Tensor] = None,
                kq: Optional[torch.Tensor] = None,
                vq: Optional[torch.Tensor] = None,
                max_blocks: int = 0) -> torch.Tensor:
    """Every SGA decoder layer in one cooperative launch (csrc/sga_decoder.cu).
    v [B, Lv, D] bf16 or f32; masks bool [B, 1, 1, L] (True = PAD); wp the
    stacked layout (ops/sga_block.py ``prepare_sga_decoder_params``). The
    cross k/v: either q [B, Lq, D] (bf16 or f32), projected in the kernel
    by wkv2 / bkv2 per layer, or kq / vq [B, L*H, Lq, Dh] (bf16 or f32, the
    last dim contiguous), layer-major. Returns [B, Lv, D] in v's dtype.
    max_blocks > 0 caps the grid (the result does not depend on it)."""
    _require((q is None) != (kq is None and vq is None)
             and (kq is None) == (vq is None),
             "sga_decoder: pass q (in-kernel k/v) or kq and vq")
    if not on_cuda(v):
        return sga_decoder_plain(v, v_mask, q_mask, wp, num_heads=num_heads,
                                 q=q, kq=kq, vq=vq)
    name = "sga_decoder"
    B, Lv, D, F, H, L = _stack_dims(name, v, wp, num_heads)
    Dh = D // H
    if q is not None:
        _same_device(name, v, q, v_mask, q_mask)
        _require(q.dim() == 3 and q.shape[0] == B and q.shape[2] == D
                 and q.dtype in (BF16, F32) and q.is_contiguous(),
                 f"{name}: q must be a contiguous bf16 or f32 [{B}, Lq, {D}]")
        Lq = q.shape[1]
        kv_args = (None, None, 0, 0, 0, 0, 0)
    else:
        _same_device(name, v, kq, vq, v_mask, q_mask)
        Lq = kq.shape[2]
        _require(kq.shape == vq.shape == (B, L * H, Lq, Dh)
                 and kq.dtype == vq.dtype and kq.dtype in (BF16, F32)
                 and kq.stride() == vq.stride() and kq.stride(3) == 1,
                 f"{name}: kq / vq must be bf16 or f32 [{B}, {L * H}, Lq, "
                 f"{Dh}] with one set of strides and the last dim contiguous")
        kv_args = (kq.data_ptr(), vq.data_ptr(), int(kq.dtype == F32),
                   kq.stride(0), H * kq.stride(1), kq.stride(1),
                   kq.stride(2))
    _check_pad(name, v_mask, B, Lv)
    _check_pad(name, q_mask, B, Lq)
    _same_device(name, v, *(wp[n] for n in DECODER_WEIGHTS
                            if q is not None or n not in ("wkv2", "bkv2")))
    DD = (L, D, D)
    shapes = {"wqkv1": (L, D, 3 * D), "bqkv1": (L, 3 * D), "wm1": DD,
              "wq2": DD, "wm2": DD, "w1": (L, D, F), "b1": (L, F),
              "w2": (L, F, D)}
    shapes.update({n: (L, D) for n in ("bm1", "ln1_s", "ln1_b", "bq2", "bm2",
                                       "ln2_s", "ln2_b", "b2", "ln3_s",
                                       "ln3_b")})
    if q is not None:
        shapes.update(wkv2=(L, D, 2 * D), bkv2=(L, 2 * D))
    w = (ctypes.c_void_p * len(DECODER_WEIGHTS))(
        *_check_stack(name, wp, DECODER_WEIGHTS, shapes))
    plan = stack_plan(B, Lv, D, F, H, Lq, "in" if q is not None else "ext")
    M, Mq = B * Lv, B * Lq
    MD = M * D
    # x32, xb, qkv, att, y, v1, v1b, qx, v2, v2b, h, qb, kv, the split
    # products' workspace (bytes)
    sizes = [4 * MD, 2 * MD, 6 * MD, 2 * MD, 4 * MD, 4 * MD, 2 * MD, 2 * MD,
             4 * MD, 2 * MD, 2 * M * F]
    sizes += [2 * Mq * D, 4 * Mq * D] if q is not None else [0, 0]
    buf, scratch = _scratch(v.device, sizes + [4 * plan.workspace_floats])
    out = torch.empty_like(v)
    info = (ctypes.c_int * 4)()
    _launch_stack(name, _lib().mcan_sga_decoder, (
        v.data_ptr(), int(v.dtype == F32), _ptr(q),
        int(q is not None and q.dtype == F32), *kv_args,
        v_mask.data_ptr(), q_mask.data_ptr(), ctypes.addressof(w),
        ctypes.addressof(scratch), out.data_ptr(), int(out.dtype == F32), B,
        Lv, Lq, D, F, H, L, 1.0 / Dh ** 0.5, LN_EPS,
        *_stack_plan_args(v.device, plan, scratch[-1]), int(max_blocks),
        ctypes.addressof(info), _stream(v)), info)
    del buf    # the caching allocator reuses it only after the launch's work
    return out


def sa_encoder(x: torch.Tensor, x_mask: torch.Tensor, wp, *, num_heads: int,
               max_blocks: int = 0) -> torch.Tensor:
    """Every SA encoder layer in one cooperative launch (csrc/sa_encoder.cu).
    x [B, Lq, D] bf16 or f32; x_mask bool [B, 1, 1, Lq] (True = PAD); wp the
    stacked layout (ops/sga_block.py ``prepare_sa_encoder_params``).
    Returns [B, Lq, D] in x's dtype. max_blocks > 0 caps the grid."""
    if not on_cuda(x):
        return sa_encoder_plain(x, x_mask, wp, num_heads=num_heads)
    name = "sa_encoder"
    B, Lq, D, F, H, L = _stack_dims(name, x, wp, num_heads)
    _check_pad(name, x_mask, B, Lq)
    _same_device(name, x, x_mask, *(wp[n] for n in ENCODER_WEIGHTS))
    shapes = {"wqkv": (L, D, 3 * D), "bqkv": (L, 3 * D), "wm": (L, D, D),
              "w1": (L, D, F), "b1": (L, F), "w2": (L, F, D)}
    shapes.update({n: (L, D) for n in ("bm", "ln1_s", "ln1_b", "b2", "ln2_s",
                                       "ln2_b")})
    w = (ctypes.c_void_p * len(ENCODER_WEIGHTS))(
        *_check_stack(name, wp, ENCODER_WEIGHTS, shapes))
    plan = stack_plan(B, Lq, D, F, H)
    MD = B * Lq * D
    # x32, xb, qkv, att, y, x1, x1b, h, the split products' workspace
    # (bytes)
    buf, scratch = _scratch(x.device, [4 * MD, 2 * MD, 6 * MD, 2 * MD, 4 * MD,
                                       4 * MD, 2 * MD, 2 * B * Lq * F,
                                       4 * plan.workspace_floats])
    out = torch.empty_like(x)
    info = (ctypes.c_int * 4)()
    _launch_stack(name, _lib().mcan_sa_encoder, (
        x.data_ptr(), int(x.dtype == F32), x_mask.data_ptr(),
        ctypes.addressof(w), ctypes.addressof(scratch), out.data_ptr(),
        int(out.dtype == F32), B, Lq, D, F, H, L, 1.0 / (D // H) ** 0.5,
        LN_EPS, *_stack_plan_args(x.device, plan, scratch[-1]),
        int(max_blocks), ctypes.addressof(info), _stream(x)), info)
    del buf
    return out


# ---------------------------------------------------------------------------
# the streaming FFN + LayerNorm: ffn_ln_blocked (M outer), ffn_ln_wstationary
# (F outer, weight-stationary)
# ---------------------------------------------------------------------------

FFN_LN_MAX_WIDTH = 2048   # D: a multiple of 128 up to this
FFN_LN_ROWS = 64          # a row tile: one consumer warpgroup (wgmma m64)
FFN_LN_MAX_CLUSTER = 8    # CTAs a cluster: the portable size
FFN_LN_VARIANTS = ("blocked", "wstationary")
# the F steps the kernels take by width (the parent kernels' F tile and
# slice): F a multiple of 64 / 128 / 256 (blocked) or 32 / 32 / 16
# (weight-stationary) for D up to 512 / 1024 / 2048
FFN_LN_F_STEPS = {"blocked": (64, 128, 256), "wstationary": (32, 32, 16)}
# both kernels' rings: as many slots as the shared memory beside their
# other buffers holds, within these bounds
FFN_MIN_STAGES, FFN_MAX_STAGES = 2, 8
# ffn_ln_wstationary.cu: the hidden units a CTA holds by its output columns
# (TS: W1's slice is D x TS, W2's rows of the range C TS x BN)
FFN_WS_TS = {64: 32, 128: 32, 256: 16}
FFN_SPLIT_FILL = 0.5      # blocked: split F where the clusters fill less


def ffn_ln_bn(D: int) -> int:
    """The output columns a CTA owns at width D: 64 up to 512, 128 up to
    1024, 256 up to 2048, so a cluster is D / BN <= 8 CTAs."""
    return 64 if D <= 512 else 128 if D <= 1024 else 256


def ffn_f_step(variant: str, D: int) -> int:
    """The F step a streaming kernel takes at width D; 0 for a width it does
    not take (not a multiple of 128, or past 2048)."""
    if D < 128 or D > FFN_LN_MAX_WIDTH or D % 128:
        return 0
    steps = FFN_LN_F_STEPS[variant]
    return steps[0] if D <= 512 else steps[1] if D <= 1024 else steps[2]


def ffn_ln_smem_bytes(variant: str, x_f32: bool, D: int, bn: int,
                      cluster: int, ts: int, stages: int) -> int:
    """The dynamic shared memory of one launch (the instance's Cfg::smem):
    1 KB of slack to align the first buffer, then
      blocked: the ring (a slot: the larger of x's K-tile -- one bf16 box,
        or two f32 -- with W1's box, and W2's bn / 64 boxes), the cluster's
        h pieces (one box a rank), the barriers, the rows' statistics (16
        bytes a row), b2 / gamma / beta of the CTA's columns, a flag;
      wstationary: W1's slice (D x 2 ts bytes), W2's rows of the range
        (K-tiles of 64 x bn / 64 boxes), the cluster's h pieces (64 x 2 ts
        bytes each), the ring of x's K-tiles, the barriers, the rows'
        statistics."""
    box, xs = 64 * GEMM_BK * 2, 2 if x_f32 else 1
    if variant == "blocked":
        slot = max(xs * box + box, bn // 64 * box)
        return (1024 + stages * slot + cluster * box + 16 * stages + 32
                + FFN_LN_ROWS * 16 + 3 * bn * 4 + 16)
    row = 2 * ts
    w2_tiles = -(-cluster * ts // GEMM_BK)
    return (1024 + D * row + w2_tiles * (bn // 64) * box
            + cluster * FFN_LN_ROWS * row + stages * xs * box + 16 * stages
            + 64 + FFN_LN_ROWS * 16)


def _ffn_stages(variant: str, x_f32: bool, D: int, bn: int, cluster: int,
                ts: int) -> int:
    """The deepest ring (at most FFN_MAX_STAGES slots) whose launch fits a
    block's shared memory; raises where not even FFN_MIN_STAGES fit."""
    fits = [n for n in range(FFN_MIN_STAGES, FFN_MAX_STAGES + 1)
            if ffn_ln_smem_bytes(variant, x_f32, D, bn, cluster, ts, n)
            <= SMEM_PER_BLOCK]
    _require(bool(fits), f"ffn_ln_plan: no ring fits at D={D}")
    return max(fits)


@dataclass(frozen=True)
class FfnLnPlan:
    """How a streaming FFN + LN kernel covers one call (``ffn_ln_plan``):
    64-row tiles; a cluster of ``cluster`` CTAs, rank c owning the output
    columns ``columns(c)`` (``bn`` each) and ``f_width / cluster`` of each
    F step's hidden units; F in ``f_steps`` steps of ``f_width``.

    blocked: a cluster per row block and split; the F tiles (64 hidden
      units a rank) walked in order, split at small M into ``splits``
      ranges of F tiles (``f_range``), one cluster each, summed in range
      order.
    wstationary: the F ranges (``ts`` hidden units a rank, held in shared
      memory) dealt to ``clusters`` clusters (range g to cluster g %
      clusters), each walking every row tile; the ranges' sums chained in
      range order.

    ``stages`` and ``smem``: the ring's slots (as many as fit beside the
    other buffers, 2 to 8) and the launch's dynamic shared memory.
    Everything but ``clusters`` (wstationary: the card's or the caller's
    cap) follows from the shape alone, and the bits do not depend on
    ``clusters``."""
    variant: str
    M: int
    D: int
    F: int
    x_f32: bool
    bn: int
    cluster: int
    f_width: int
    f_steps: int
    splits: int
    ts: int
    clusters: int
    stages: int
    smem: int

    @property
    def row_blocks(self) -> int:
        return -(-self.M // FFN_LN_ROWS)

    @property
    def grid(self) -> int:
        return self.cluster * self.clusters

    def rows(self, block: int) -> Tuple[int, int]:
        return block * FFN_LN_ROWS, min(self.M, (block + 1) * FFN_LN_ROWS)

    def columns(self, rank: int) -> Tuple[int, int]:
        return rank * self.bn, min(self.D, (rank + 1) * self.bn)

    def f_range(self, i: int) -> Tuple[int, int]:
        """The hidden units of blocked split i (its F tiles [i T / S, (i +
        1) T / S)) or of weight-stationary range i, clipped to F."""
        if self.variant == "blocked":
            t0 = i * self.f_steps // self.splits
            t1 = (i + 1) * self.f_steps // self.splits
        else:
            t0, t1 = i, i + 1
        return (min(self.F, t0 * self.f_width), min(self.F, t1 * self.f_width))

    def ranges_of(self, cluster: int) -> List[int]:
        """wstationary: the F ranges cluster `cluster` walks, in order."""
        return list(range(cluster, self.f_steps, self.clusters))

    @property
    def workspace_floats(self) -> int:
        """blocked: the split partials (splits x the row blocks' 64 x C bn
        f32); 0 unsplit."""
        if self.variant != "blocked" or self.splits == 1:
            return 0
        return (self.splits * self.row_blocks * self.cluster * FFN_LN_ROWS
                * self.bn)

    @property
    def flags(self) -> int:
        """wstationary: the chain's flags, one a row tile and rank."""
        return self.row_blocks * self.cluster \
            if self.variant == "wstationary" else 0

    def fields(self) -> Tuple[int, ...]:
        """What the C entry takes: bn, cluster, f_width, f_steps, then
        splits, row_blocks, grid (blocked) or ts, row_blocks, clusters, grid
        (wstationary), then stages, smem."""
        if self.variant == "blocked":
            mid = (self.splits, self.row_blocks, self.grid)
        else:
            mid = (self.ts, self.row_blocks, self.clusters, self.grid)
        return (self.bn, self.cluster, self.f_width, self.f_steps, *mid,
                self.stages, self.smem)


def _check_ffn_shape(name: str, variant: str, D: int, F: int) -> int:
    f_step = ffn_f_step(variant, D)
    _require(f_step > 0 and F > 0 and F % f_step == 0,
             f"{name}: takes D a multiple of 128 up to {FFN_LN_MAX_WIDTH} "
             f"and F a multiple of its F step ({f_step}); got D={D}, F={F}")
    return f_step


@functools.lru_cache(maxsize=1024)
def ffn_ln_plan(variant: str, M: int, D: int, F: int, x_f32: bool,
                max_clusters: int = 0) -> FfnLnPlan:
    """The plan of one streaming FFN + LN call from the shape alone.

    Both: 64-row tiles; BN = ``ffn_ln_bn(D)`` output columns a CTA, a
    cluster of C = ceil(D / BN) CTAs (2 to 8).
    blocked: F tiles of 64 C hidden units; where the row blocks' clusters
      give fewer than ``FFN_SPLIT_FILL`` of the card's SMs a CTA, the F
      tiles split into as many ranges as fill the SMs (at most one F tile a
      range): B=1's 60 rows at MCAN-large run 8 clusters of 8.
    wstationary: F ranges of C TS hidden units (TS = ``FFN_WS_TS[BN]``: W1's
      slice and W2's rows in shared memory beside x's ring), one cluster
      each as far as ``max_clusters`` (> 0: the card's or the caller's cap)
      and the card's SMs allow; a cluster walks several ranges past that."""
    _require(variant in FFN_LN_VARIANTS, f"ffn_ln_plan: variant {variant!r}")
    _check_ffn_shape("ffn_ln_plan", variant, D, F)
    _require(M >= 1, f"ffn_ln_plan: M={M}")
    x_f32 = bool(x_f32)
    bn = ffn_ln_bn(D)
    cluster = -(-D // bn)
    rows = -(-M // FFN_LN_ROWS)
    if variant == "blocked":
        f_width = FFN_LN_ROWS * cluster
        f_steps = -(-F // f_width)
        ctas = rows * cluster
        splits = 1
        if ctas < FFN_SPLIT_FILL * GEMM_SMS:
            splits = max(1, min(f_steps, GEMM_SMS // ctas))
        stages = _ffn_stages(variant, x_f32, D, bn, cluster, 0)
        return FfnLnPlan(variant, M, D, F, x_f32, bn, cluster, f_width,
                         f_steps, splits, 0, rows * splits, stages,
                         ffn_ln_smem_bytes(variant, x_f32, D, bn, cluster, 0,
                                           stages))
    ts = FFN_WS_TS[bn]
    f_width = cluster * ts
    f_steps = -(-F // f_width)
    cap = GEMM_SMS // cluster
    if max_clusters > 0:
        cap = min(cap, max_clusters)
    stages = _ffn_stages(variant, x_f32, D, bn, cluster, ts)
    return FfnLnPlan(variant, M, D, F, x_f32, bn, cluster, f_width, f_steps,
                     1, ts, min(f_steps, cap), stages,
                     ffn_ln_smem_bytes(variant, x_f32, D, bn, cluster, ts,
                                       stages))


def ffn_ln_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
    """StdLayerNorm(x + relu(x . w1 + b1) . w2 + b2) at the streaming
    kernels' precision: x read as f32 and rounded to bf16 for the first
    product, h rounded to bf16, products summed in f32, r = (x + h . w2) +
    b2, the reference LN divided by (std + eps); f32 [M, D]."""
    x32 = x.float()
    h = torch.relu(bf16_matmul(x32, w1) + b1).to(BF16)
    r = x32 + bf16_matmul(h, w2) + b2
    return std_layer_norm(r, gamma, beta, LN_EPS)


def _check_ffn(name: str, x, w1, b1, w2, b2, gamma, beta, variant: str):
    """The operands the streaming kernels take (F a multiple of their F
    step, ``ffn_f_step``) -> (M, D, F); raises for any other."""
    _same_device(name, x, w1, b1, w2, b2, gamma, beta)
    _require(x.dim() == 2 and x.dtype in (F32, BF16) and x.is_contiguous()
             and x.data_ptr() % 16 == 0,
             f"{name}: x must be a contiguous 16-byte aligned f32 or bf16 "
             f"[M, D]")
    M, D = x.shape
    _require(w1.dim() == 2 and w1.shape[0] == D and w2.dim() == 2
             and tuple(w2.shape) == (w1.shape[1], D),
             f"{name}: w1 [D, F] and w2 [F, D] with D={D}, got "
             f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    F = w1.shape[1]
    _check_ffn_shape(name, variant, D, F)
    for w in (w1, w2):
        _require(w.dtype == BF16 and w.is_contiguous()
                 and w.data_ptr() % 16 == 0,
                 f"{name}: w1 and w2 must be contiguous 16-byte aligned bf16")
    _check_vec(name, b1, F)
    for t in (b2, gamma, beta):
        _check_vec(name, t, D)
        _require(t.data_ptr() % 16 == 0,
                 f"{name}: b2, gamma and beta must be 16-byte aligned")
    return M, D, F


_FFN_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_FFN_FIT: Dict[Tuple, int] = {}


def _ffn_plan_args(plan: FfnLnPlan):
    """The plan's int fields as a ctypes array (passed by address, kept
    alive by the call) and their count."""
    fields = plan.fields()
    return (ctypes.c_int * len(fields))(*fields), len(fields)


def ffn_ln_blocked(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """StdLayerNorm(x + relu(x . w1 + b1) . w2 + b2) in one launch of
    csrc/ffn_ln_blocked.cu (``_ffn_ln_blocked_kernel``,
    mcan_vqa_tpu/ops/fused_ffn.py:121): a cluster per 64-row block walks
    the F tiles, the hidden never leaves shared memory; at small M the F
    tiles split over clusters, summed in range order (``ffn_ln_plan``). x
    [M, D] f32 or bf16, w1 [D, F] and w2 [F, D] bf16, vectors f32 -> f32
    [M, D]. D a multiple of 128 up to 2048, F a multiple of the F step
    (``ffn_f_step``), any M."""
    if not on_cuda(x):
        return ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta)
    name = "ffn_ln_blocked"
    M, D, F = _check_ffn(name, x, w1, b1, w2, b2, gamma, beta, "blocked")
    out = torch.empty((M, D), dtype=F32, device=x.device)
    if M == 0:
        return out
    plan = ffn_ln_plan("blocked", M, D, F, x.dtype == F32)
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_floats, dtype=F32, device=x.device)
        counters = _zeroed_counters(_FFN_COUNTERS, x.device, plan.row_blocks,
                                    "ffn_ln_blocked: the row-block counters")
    fields, n = _ffn_plan_args(plan)
    rc = _lib().mcan_ffn_ln_blocked(
        x.data_ptr(), int(x.dtype == F32), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), _ptr(ws), _ptr(counters), M, D, F, LN_EPS, fields, n,
        _stream(x))
    _check(rc, name)
    return out


def _ffn_ws_fit(device: torch.device, plan: FfnLnPlan) -> int:
    """The clusters of the plan's instance the card holds at once (the C
    library's cudaOccupancyMaxActiveClusters), once per device and
    instance."""
    key = (device, plan.x_f32, plan.bn, plan.ts, plan.cluster, plan.smem)
    if key not in _FFN_FIT:
        fit = _lib().mcan_ffn_ln_wstationary_max_clusters(
            int(plan.x_f32), plan.bn, plan.ts, plan.cluster, plan.smem)
        _require(fit > 0, f"ffn_ln_wstationary: the card holds no cluster "
                          f"of {plan.cluster} CTAs at {plan.smem} B ({fit})")
        _FFN_FIT[key] = fit
    return _FFN_FIT[key]


def ffn_ln_wstationary(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor,
                       gamma: torch.Tensor, beta: torch.Tensor, *,
                       max_clusters: int = 0) -> torch.Tensor:
    """The same function in one cluster launch of
    csrc/ffn_ln_wstationary.cu (``_ffn_ln_wstationary_kernel``,
    fused_ffn.py:201): a cluster holds an F range of W1 and W2 in its CTAs'
    shared memory, loaded once, and walks every row tile; the ranges' sums
    pass in range order through the output, one int32 flag per row tile
    and rank (zeroed per call). D a multiple of 128 up to 2048, F a
    multiple of the F step (``ffn_f_step``), any M. max_clusters > 0 caps
    the clusters (the result does not depend on it); every cluster of the
    grid is resident at once. ``LAST_GRID["ffn_ln_wstationary"]`` holds the
    last launch's (grid CTAs, clusters, clusters the card holds at once,
    shared memory bytes)."""
    if not on_cuda(x):
        return ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta)
    name = "ffn_ln_wstationary"
    M, D, F = _check_ffn(name, x, w1, b1, w2, b2, gamma, beta, "wstationary")
    out = torch.empty((M, D), dtype=F32, device=x.device)
    if M == 0:
        return out
    x_f32 = x.dtype == F32
    fit = _ffn_ws_fit(x.device, ffn_ln_plan("wstationary", M, D, F, x_f32))
    cap = min(fit, max_clusters) if max_clusters > 0 else fit
    plan = ffn_ln_plan("wstationary", M, D, F, x_f32, cap)
    flags = torch.zeros(plan.flags, dtype=torch.int32, device=x.device)
    info = (ctypes.c_int * 4)()
    fields, n = _ffn_plan_args(plan)
    _launch_stack(name, _lib().mcan_ffn_ln_wstationary, (
        x.data_ptr(), int(x_f32), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), flags.data_ptr(), M, D, F, LN_EPS, fields, n,
        ctypes.addressof(info), _stream(x)), info)
    return out
