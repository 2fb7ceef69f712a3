"""Wrappers of the hand-written CUDA MSDA kernels: the forwards
(csrc/msda_fwd.cu) and their backwards (csrc/msda_bwd.cu).

``msda_fwd``, ``msda_fwd_factored``, ``msda_bwd`` and ``msda_bwd_factored``
check their inputs, allocate the outputs and launch kernels on the current
CUDA stream. Their plain counterparts are ``ops.msda.ms_deform_attn_ref``
and the materialization of the factored operands followed by it.
``msda_fwd`` replaces the Pallas kernels ``_msda_kernel``,
``_msda_kernel_slab``, ``_msda_kernel_masked``, ``_msda_kernel_window`` and
``_msda_kernel_ml_chunk`` of the JAX package; ``msda_fwd_factored``
replaces ``_msda_kernel_pt2d``. ``msda_bwd`` is the gradient of
``msda_fwd`` and ``msda_bwd_factored`` that of ``msda_fwd_factored``; their
plain counterparts are autograd through the plain versions (the JAX
package's backwards are XLA VJPs of its plain versions, not Pallas kernels).

Launch counts: ``launches_plain`` (no tile mask: TSA, det and map decoder
cross-attention), ``launches_masked`` (single-level SCA with its
per-(camera, tile) mask) and ``launches_factored`` (multi-level SCA on
factored operands) each grow by one per kernel launch, so a run can show
that its main path went through the kernels. ``launches_plain_by_variant``,
``launches_masked_by_variant`` and ``launches_factored_by_variant`` split
them by the kernel variant that ran (``VARIANTS``, chosen as
``fwd_variant`` says): ``vector`` (16-byte gathers, D * element size a
power-of-two multiple of 16 bytes, aligned rows), ``narrow`` (rows of 4 or
8 bytes: f32 D = 1 or 2, bf16 D = 2 or 4, a batch element's within
NARROW_STAGE_BYTES; a lane per sample of several (batch, query, head)
items) or ``general`` (scalar channels, any D; the
factored entry runs vector or general). ``launches_bwd_plain`` and
``launches_bwd_masked`` count the backward's launches without and with a
tile mask, and ``launches_bwd_plain_by_variant`` /
``launches_bwd_masked_by_variant`` split them by the plan that ran
(``BWD_VARIANTS``, chosen by ``bwd_plan``): ``gather`` (the vector
kernel, several items a warp, pushing each corner onto its row's lists,
then a pass over the rows that sums them and writes grad_value in value's
dtype), ``private`` (D = 1 or 2 where a batch element's f32 grad_value rows
and value rows fit PRIVATE_BWD_BYTES of shared memory: a block sums its run of items'
grad_value there and adds it to an f32 scratch once) or ``general`` (any
head width or alignment: a warp per item, f32 atomics into a scratch).
``launches_bwd_factored``
counts the factored backward's launches and
``launches_bwd_factored_by_variant`` splits them by
``BWD_FACTORED_VARIANTS``: ``privatized`` (the vector kernel with the
grad_value rows of the coarsest levels summed in shared memory, as
``factored_bwd_plan`` chooses), ``vector`` (the same kernel with no level
small enough) or ``general``.

``msda_fwd_local`` and ``msda_bwd_local`` are the tile-local entry and its
gradient, for calls whose queries are the cells of the value's own single
level (L = 1, Q = h·w, query q at cell (q // w, q % w)), as DCNv3 makes
them: a block stages a tile's halo of value rows in shared memory
(``LOCAL_HALO``, ``LOCAL_FWD_TILE``, ``LOCAL_BWD_TILE``). f32 only, D a
multiple of 4 up to 32; ``check_local`` refuses anything else before any
device is touched. Their plain counterparts are ``ms_deform_attn_ref`` and
autograd through it. ``launches_local`` and ``launches_bwd_local`` count
their launches.

``msda_fwd_resident`` and ``msda_bwd_resident`` are the map-resident entry
and its gradient, for f32 single-level calls whose whole map is small (SCA
over the cameras' 15x25 map): a block stages the whole map of a group of
``resident_heads`` heads in shared memory and takes every n-th tile of
their (query, head) items, with or without a tile mask.
``takes_resident`` is the rule by which ``ops.msda.ms_deform_attn`` sends
a call there; ``check_resident`` refuses what the kernels do not take
before any device is touched. Their plain counterparts are
``ms_deform_attn_ref`` and autograd through it. ``launches_resident`` and
``launches_bwd_resident`` count their launches.

``ARGTYPES`` are the C signatures of the entry points as ctypes sees them:
``c_void_p`` for every pointer and the stream, ``c_int`` for every int.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

SOURCE = "msda_fwd.cu"
BWD_SOURCE = "msda_bwd.cu"

launches_plain = 0
launches_masked = 0
launches_factored = 0
launches_bwd_plain = 0
launches_bwd_masked = 0
launches_bwd_factored = 0
launches_local = 0
launches_bwd_local = 0
launches_resident = 0
launches_bwd_resident = 0
# the C entry reports the variant it launched: 1 vector, 2 narrow, 0 general
VARIANTS = {1: "vector", 2: "narrow", 0: "general"}
launches_plain_by_variant = dict.fromkeys(VARIANTS.values(), 0)
launches_masked_by_variant = dict.fromkeys(VARIANTS.values(), 0)
launches_factored_by_variant = dict.fromkeys(VARIANTS.values(), 0)
BWD_VARIANTS = {1: "gather", 2: "private", 0: "general"}
launches_bwd_plain_by_variant = dict.fromkeys(BWD_VARIANTS.values(), 0)
launches_bwd_masked_by_variant = dict.fromkeys(BWD_VARIANTS.values(), 0)
BWD_FACTORED_VARIANTS = {2: "privatized", 1: "vector", 0: "general"}
launches_bwd_factored_by_variant = dict.fromkeys(
    BWD_FACTORED_VARIANTS.values(), 0)
# msda_bwd_factored's vector kernel: the shared memory a block may take to
# sum the private levels' grad_value rows (two blocks an SM), and the
# queries a block takes; the C entry holds the same two numbers
# (csrc/msda_bwd.cu kPrivMaxBytes, kPrivRun) and refuses a plan beyond them
FACTORED_BWD_PRIVATE_BYTES = 100 * 1024
FACTORED_BWD_RUN = 128
# msda_bwd's private plan: the shared memory a block may take for a batch
# element's f32 grad_value rows and its value rows (two blocks an SM;
# csrc/msda_bwd.cu kPrivateMaxBytes, whose entry refuses the plan beyond it)
PRIVATE_BWD_BYTES = 96 * 1024
# the plain and masked entry's narrow variant: the bytes of a row it takes,
# and of a batch element's value rows, which it stages in shared memory
# (csrc/msda_fwd.cu kNarrowStageBytes)
NARROW_ROW_BYTES = (4, 8)
NARROW_STAGE_BYTES = 40 * 1024
# the tile-local entries (csrc/msda_common.cuh kLocalHalo, kLocalThreads,
# kLocalFwdTileY/X, kLocalBwdTileY/X, kLocalMaxSmem): the halo's cells a
# side, a block's threads, the (rows, columns) of a tile, and a block's
# shared memory on sm_90; the head widths they take; the backward's slots
# index a 16-bit list (a tile's corners at most 2^16)
LOCAL_HALO = 2
LOCAL_THREADS = 256
LOCAL_FWD_TILE = (8, 16)
LOCAL_BWD_TILE = (8, 16)
LOCAL_MAX_SMEM = 232448
LOCAL_WIDTHS = tuple(range(4, 33, 4))
LOCAL_BWD_MAX_SLOTS = 65536

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    # value, dtype, loc, attn, tile_mask, out, B, V, H, D, Q, L, P, shapes,
    # q_tile, stream, variant
    "msda_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                 _P, _P],
    # value, dtype, ref, off, attn, tile_mask, out, B, N, V, H, D, Q, L, P,
    # shapes, q_tile, stream, variant
    "msda_fwd_factored": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P, _I, _P, _P],
    # value, dtype, loc, attn, tile_mask, grad_out, grad_value_f32,
    # grad_value, grad_loc, grad_attn, row_head, slot_links, B, V, H, D, Q,
    # L, P, shapes, q_tile, plan, stream, variant
    "msda_bwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                 _I, _I, _I, _I, _P, _I, _I, _P, _P],
    # value, dtype, ref, off, attn, tile_mask, grad_out, grad_value_f32,
    # grad_value, grad_ref, grad_off, grad_attn, B, N, V, H, D, Q, L, P,
    # shapes, q_tile, private_from, stream, variant
    "msda_bwd_factored": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P],
    # value, loc, attn, out, B, h, w, H, D, P, stream
    "msda_fwd_local": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # value, loc, attn, grad_out, grad_value, grad_loc, grad_attn, B, h, w,
    # H, D, P, stream
    "msda_bwd_local": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P],
    # value, loc, attn, tile_mask, out, B, h, w, H, D, Q, P, q_tile, stream
    "msda_fwd_resident": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # value, loc, attn, tile_mask, grad_out, grad_value, grad_loc,
    # grad_attn, B, h, w, H, D, Q, P, q_tile, stream
    "msda_bwd_resident": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P],
}
# the source of each entry point
ENTRY_SOURCE = {"msda_fwd": SOURCE, "msda_fwd_factored": SOURCE,
                "msda_fwd_local": SOURCE, "msda_bwd": BWD_SOURCE,
                "msda_bwd_factored": BWD_SOURCE, "msda_bwd_local": BWD_SOURCE,
                "msda_fwd_resident": SOURCE, "msda_bwd_resident": BWD_SOURCE}


def reset_launch_counts() -> None:
    global launches_plain, launches_masked, launches_factored
    global launches_bwd_plain, launches_bwd_masked, launches_bwd_factored
    global launches_local, launches_bwd_local
    global launches_resident, launches_bwd_resident
    launches_local = 0
    launches_bwd_local = 0
    launches_resident = 0
    launches_bwd_resident = 0
    launches_plain = 0
    launches_masked = 0
    launches_factored = 0
    launches_bwd_plain = 0
    launches_bwd_masked = 0
    launches_bwd_factored = 0
    for counts in (launches_plain_by_variant, launches_masked_by_variant,
                   launches_factored_by_variant):
        counts.update(dict.fromkeys(VARIANTS.values(), 0))
    launches_bwd_factored_by_variant.update(
        dict.fromkeys(BWD_FACTORED_VARIANTS.values(), 0))
    for counts in (launches_bwd_plain_by_variant, launches_bwd_masked_by_variant):
        counts.update(dict.fromkeys(BWD_VARIANTS.values(), 0))


def _lib(source: str = SOURCE) -> ctypes.CDLL:
    from apollo_vision_net_tpu_torch.ops import _build

    lib = _build.load(source)
    names = [n for n, s in ENTRY_SOURCE.items() if s == source]
    if getattr(lib, names[0]).argtypes is None:
        for name in names:
            getattr(lib, name).argtypes = ARGTYPES[name]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, value on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fwd_variant(V: int, H: int, D: int, element_size: int,
                offset: int = 0) -> str:
    """The variant of a plain or masked ``msda_fwd`` call (a value of
    VARIANTS) on value (B, V, H, D), for value (and out) ``offset`` bytes
    past a 16-byte boundary and loc 8-byte aligned, as csrc/msda_fwd.cu
    launch_msda picks it: "vector" when D fills G = D·size/16 lanes, G in
    {1, 2, 4, 8, 16}, on aligned rows; "narrow" when a row is 4 or 8 bytes,
    aligned to its size, and a batch element's V·H rows take at most
    NARROW_STAGE_BYTES; else "general"."""
    vec = 16 // element_size
    if offset % 16 == 0 and D % vec == 0 and D // vec in (1, 2, 4, 8, 16):
        return "vector"
    row = D * element_size
    if (row in NARROW_ROW_BYTES and offset % row == 0
            and V * H * row <= NARROW_STAGE_BYTES):
        return "narrow"
    return "general"


def msda_fwd(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    *,
    tile_mask: Optional[torch.Tensor] = None,
    q_tile: int = 32,
) -> torch.Tensor:
    """value (B, V, H, D) f32|bf16, loc (B, Q, H, L, P, 2) f32, attn
    (B, Q, H, L, P) f32, tile_mask (B, ceil(Q / q_tile)) int32 or None ->
    (B, Q, H * D) in value's dtype."""
    global launches_plain, launches_masked
    if value.device.type != "cuda":
        raise ValueError(f"msda_fwd launches on CUDA tensors, got {value.device}")
    if value.dim() != 4 or sampling_locations.dim() != 6:
        raise ValueError("value must be (B, V, H, D), locations (B, Q, H, L, P, 2)")
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if len(spatial_shapes) != L or sum(h * w for h, w in spatial_shapes) != V:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match V={V}, L={L}")
    dev = value.device
    _check("value", value, (B, V, H, D), (torch.float32, torch.bfloat16), dev)
    _check("sampling_locations", sampling_locations, (B, Q, H, L, P, 2),
           (torch.float32,), dev)
    _check("attention_weights", attention_weights, (B, Q, H, L, P),
           (torch.float32,), dev)
    if tile_mask is not None:
        _check("tile_mask", tile_mask, (B, (Q + q_tile - 1) // q_tile),
               (torch.int32,), dev)
    lib = _lib()
    out = torch.empty((B, Q, H * D), dtype=value.dtype, device=dev)
    shapes = (ctypes.c_int * (2 * L))(*[int(s) for hw in spatial_shapes for s in hw])
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = (ctypes.c_int * 1)(-1)
    err = lib.msda_fwd(
        value.data_ptr(), _DTYPES[value.dtype], sampling_locations.data_ptr(),
        attention_weights.data_ptr(),
        tile_mask.data_ptr() if tile_mask is not None else None,
        out.data_ptr(), B, V, H, D, Q, L, P, shapes, q_tile, stream, variant)
    if err != 0:
        raise RuntimeError(f"msda_fwd kernel launch failed: CUDA error {err}")
    if tile_mask is None:
        launches_plain += 1
        by_variant = launches_plain_by_variant
    else:
        launches_masked += 1
        by_variant = launches_masked_by_variant
    if variant[0] in VARIANTS:  # an empty call launches nothing
        by_variant[VARIANTS[variant[0]]] += 1
    return out


def _factored_shapes(value, spatial_shapes, ref_flat, attn_flat):
    """(B, V, H, D, Q, L, P, Bs) of a factored call, checked against each
    other."""
    if value.dim() != 4 or ref_flat.dim() != 3:
        raise ValueError("value must be (B, V, H, D), ref_flat (B, Q, P * 2)")
    B, V, H, D = value.shape
    _, Q, P2 = ref_flat.shape
    P, L, Bs = P2 // 2, len(spatial_shapes), attn_flat.shape[0]
    if sum(h * w for h, w in spatial_shapes) != V:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match V={V}")
    if P2 % 2 or Bs < 1 or B % Bs:
        raise ValueError(f"ref_flat {tuple(ref_flat.shape)} / attn batch {Bs} "
                         f"do not fit value batch {B}")
    return B, V, H, D, Q, L, P, Bs


def _check_factored(value, ref_flat, off_flat, attn_flat, tile_mask, q_tile,
                    shapes):
    B, V, H, D, Q, L, P, Bs = shapes
    dev = value.device
    _check("value", value, (B, V, H, D), (torch.float32, torch.bfloat16), dev)
    _check("ref_flat", ref_flat, (B, Q, 2 * P), (torch.float32,), dev)
    _check("off_flat", off_flat, (Bs, Q, H * L * P * 2), (torch.float32,), dev)
    _check("attn_flat", attn_flat, (Bs, Q, H * L * P), (torch.float32,), dev)
    if tile_mask is not None:
        _check("tile_mask", tile_mask, (B, (Q + q_tile - 1) // q_tile),
               (torch.int32,), dev)


def msda_fwd_factored(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    ref_flat: torch.Tensor,
    off_flat: torch.Tensor,
    attn_flat: torch.Tensor,
    *,
    tile_mask: Optional[torch.Tensor] = None,
    q_tile: int = 128,
) -> torch.Tensor:
    """value (B, V, H, D) f32|bf16; ref_flat (B, Q, P·2) f32 per camera;
    off_flat (Bs, Q, H·L·P·2) f32 in cells of each level and attn_flat
    (Bs, Q, H·L·P) f32, shared by the N = B / Bs cameras of a sample
    (camera axis fast); tile_mask (B, ceil(Q / q_tile)) int32 or None ->
    (B, Q, H * D) in value's dtype. Locations are formed in the kernel."""
    global launches_factored
    if value.device.type != "cuda":
        raise ValueError(f"msda_fwd_factored launches on CUDA tensors, got {value.device}")
    shapes_ = _factored_shapes(value, spatial_shapes, ref_flat, attn_flat)
    B, V, H, D, Q, L, P, Bs = shapes_
    _check_factored(value, ref_flat, off_flat, attn_flat, tile_mask, q_tile,
                    shapes_)
    dev = value.device
    lib = _lib()
    out = torch.empty((B, Q, H * D), dtype=value.dtype, device=dev)
    shapes = (ctypes.c_int * (2 * L))(*[int(s) for hw in spatial_shapes for s in hw])
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = (ctypes.c_int * 1)(-1)
    err = lib.msda_fwd_factored(
        value.data_ptr(), _DTYPES[value.dtype], ref_flat.data_ptr(),
        off_flat.data_ptr(), attn_flat.data_ptr(),
        tile_mask.data_ptr() if tile_mask is not None else None,
        out.data_ptr(), B, B // Bs, V, H, D, Q, L, P, shapes, q_tile, stream,
        variant)
    if err != 0:
        raise RuntimeError(f"msda_fwd_factored kernel launch failed: CUDA error {err}")
    launches_factored += 1
    if variant[0] in VARIANTS:  # an empty call launches nothing
        launches_factored_by_variant[VARIANTS[variant[0]]] += 1
    return out


# msda_bwd's vector kernel: warps a block, the head widths it takes (D = 4
# G, G = 1, 2, 4, 8) and the bounds of an item's lane slot (csrc/
# msda_bwd.cu kBwdWarps, kSlotLog2Min, kSlotLog2Max)
BWD_VEC_WARPS = 4
BWD_VECTOR_WIDTHS = (4, 8, 16, 32)
# the head widths of its private plan (csrc/msda_bwd.cu: D == 1 || D == 2)
BWD_PRIVATE_WIDTHS = (1, 2)
BWD_SLOT_MIN, BWD_SLOT_MAX = 4, 32
_INT32_MAX = 2**31 - 1


def bwd_items_per_warp(lp: int) -> int:
    """Items (batch, query, head) a warp of msda_bwd's vector kernel takes:
    32 over the lane slot of an item, L·P rounded up to a power of two
    between BWD_SLOT_MIN and BWD_SLOT_MAX (an item of more samples takes
    rounds of 32; csrc/msda_bwd.cu bwd_slot_log2)."""
    slot = BWD_SLOT_MIN
    while slot < BWD_SLOT_MAX and slot < lp:
        slot *= 2
    return 32 // slot


def bwd_aligned(value: torch.Tensor, grad_out: torch.Tensor) -> bool:
    """Whether value and grad_out start on a boundary of min(D, 4)
    channels: 4 as msda_bwd's gather kernel loads them, a whole row of D
    = 1 or 2 as the private plan's does."""
    align = min(value.shape[-1], 4) * value.element_size()
    return value.data_ptr() % align == 0 and grad_out.data_ptr() % align == 0


def bwd_gather_scratch(B: int, V: int, H: int, Q: int, lp: int) -> dict:
    """int32 elements of the gather plan's lists: a head for each value
    row (``row_head``, B·V·H) and a (link, weight) pair for each corner of
    each sample (``slot_links``, 2·B·Q·H·L·P·4)."""
    return {"row_head": B * V * H, "slot_links": 2 * B * Q * H * lp * 4}


def bwd_private_bytes(V: int, H: int, D: int) -> int:
    """The shared memory that msda_bwd's private plan counts against
    PRIVATE_BWD_BYTES: a batch element's V·H rows of D f32 grad_value
    channels and its value rows staged beside them, each counted at 4
    bytes a channel in either dtype (csrc/msda_bwd.cu msda_bwd)."""
    return V * H * D * 8


def bwd_plan(B: int, V: int, H: int, D: int, Q: int, lp: int,
             aligned: bool = True) -> int:
    """The plan of a msda_bwd call (a key of BWD_VARIANTS; the C entry
    refuses one its inputs do not allow; ``aligned`` as ``bwd_aligned``):
    "gather" for D = 4, 8, 16 or 32 with aligned rows, value offsets and
    corner slots below 2^31; "private" for D = 1 or 2 with aligned rows
    whose grad_value and value rows take at most PRIVATE_BWD_BYTES
    (``bwd_private_bytes``); else "general"."""
    if not aligned:
        return 0
    if D in BWD_VECTOR_WIDTHS:
        return int(B * V * H * D <= _INT32_MAX
                   and B * Q * H * lp * 4 <= _INT32_MAX)
    if D in BWD_PRIVATE_WIDTHS and bwd_private_bytes(V, H, D) <= PRIVATE_BWD_BYTES:
        return 2
    return 0


def msda_bwd(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    tile_mask: Optional[torch.Tensor] = None,
    q_tile: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``msda_fwd`` at (value, loc, attn) for ``grad_out``
    (B, Q, H * D) in value's dtype -> (grad_value (B, V, H, D) in value's
    dtype, grad_loc (B, Q, H, L, P, 2) f32, grad_attn (B, Q, H, L, P) f32).
    grad_value is summed in f32 and rounded once: in registers over each
    row's lists (gather plan), in shared memory and then an f32 scratch
    (private) or in an f32 scratch (general)."""
    global launches_bwd_plain, launches_bwd_masked
    if value.device.type != "cuda":
        raise ValueError(f"msda_bwd launches on CUDA tensors, got {value.device}")
    if value.dim() != 4 or sampling_locations.dim() != 6:
        raise ValueError("value must be (B, V, H, D), locations (B, Q, H, L, P, 2)")
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if len(spatial_shapes) != L or sum(h * w for h, w in spatial_shapes) != V:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match V={V}, L={L}")
    dev = value.device
    _check("value", value, (B, V, H, D), (torch.float32, torch.bfloat16), dev)
    _check("sampling_locations", sampling_locations, (B, Q, H, L, P, 2),
           (torch.float32,), dev)
    _check("attention_weights", attention_weights, (B, Q, H, L, P),
           (torch.float32,), dev)
    _check("grad_out", grad_out, (B, Q, H * D), (value.dtype,), dev)
    if tile_mask is not None:
        _check("tile_mask", tile_mask, (B, (Q + q_tile - 1) // q_tile),
               (torch.int32,), dev)
    lib = _lib(BWD_SOURCE)
    plan = bwd_plan(B, V, H, D, Q, L * P, bwd_aligned(value, grad_out))
    row_head = slot_links = grad_value_f32 = None
    if BWD_VARIANTS[plan] == "gather":
        grad_value = torch.empty_like(value)
        sizes = bwd_gather_scratch(B, V, H, Q, L * P)
        row_head = torch.empty(sizes["row_head"], dtype=torch.int32, device=dev)
        slot_links = torch.empty(sizes["slot_links"], dtype=torch.int32,
                                 device=dev)
    else:
        grad_value_f32 = torch.empty((B, V, H, D), dtype=torch.float32,
                                     device=dev)
        grad_value = (grad_value_f32 if value.dtype == torch.float32
                      else torch.empty_like(value))
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    shapes = (ctypes.c_int * (2 * L))(*[int(s) for hw in spatial_shapes for s in hw])
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = (ctypes.c_int * 1)(-1)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = lib.msda_bwd(
        value.data_ptr(), _DTYPES[value.dtype], sampling_locations.data_ptr(),
        attention_weights.data_ptr(), ptr(tile_mask), grad_out.data_ptr(),
        ptr(grad_value_f32), grad_value.data_ptr(), grad_loc.data_ptr(),
        grad_attn.data_ptr(), ptr(row_head), ptr(slot_links), B, V, H, D, Q,
        L, P, shapes, q_tile, plan, stream, variant)
    if err != 0:
        raise RuntimeError(f"msda_bwd kernel launch failed: CUDA error {err}")
    if tile_mask is None:
        launches_bwd_plain += 1
        by_variant = launches_bwd_plain_by_variant
    else:
        launches_bwd_masked += 1
        by_variant = launches_bwd_masked_by_variant
    if variant[0] in BWD_VARIANTS:  # an empty call launches nothing
        by_variant[BWD_VARIANTS[variant[0]]] += 1
    return grad_value, grad_loc, grad_attn


def factored_bwd_priv_bytes(run: int, D: int, sp: int, keys: int) -> int:
    """Shared memory of msda_bwd_factored's privatizing block (csrc/
    msda_bwd.cu factored_priv_smem): ``run`` queries' grad_out rows in f32,
    8 bytes for each of their ``sp`` private samples' four corners (weight,
    row key, place in the sorted list) and 12 bytes for each of the ``keys``
    private rows (count, start, cursor), plus the list's end."""
    return run * D * 4 + run * sp * 4 * 8 + (3 * keys + 1) * 4


def factored_bwd_plan(spatial_shapes: Sequence[Tuple[int, int]], D: int,
                      P: int) -> int:
    """``private_from`` of a ``msda_bwd_factored`` call: the first of the
    longest run of levels, ending at the last, whose grad_value rows a
    block of FACTORED_BWD_RUN queries (a tile of the mask may span several
    blocks) sums in shared memory within FACTORED_BWD_PRIVATE_BYTES
    (``factored_bwd_priv_bytes``), or len(spatial_shapes) when not even the
    last level fits."""
    run = FACTORED_BWD_RUN
    private_from, keys = len(spatial_shapes), 0
    for lvl in range(len(spatial_shapes) - 1, -1, -1):
        h, w = spatial_shapes[lvl]
        sp = (len(spatial_shapes) - lvl) * P
        if (factored_bwd_priv_bytes(run, D, sp, keys + h * w)
                > FACTORED_BWD_PRIVATE_BYTES
                or run * sp * 4 > 65536 or keys + h * w > 32767):
            break
        keys += h * w
        private_from = lvl
    return private_from


def msda_bwd_factored(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    ref_flat: torch.Tensor,
    off_flat: torch.Tensor,
    attn_flat: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    tile_mask: Optional[torch.Tensor] = None,
    q_tile: int = 128,
    need_ref: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The gradient of ``msda_fwd_factored`` at (value, ref_flat, off_flat,
    attn_flat) for ``grad_out`` (B, Q, H * D) in value's dtype ->
    (grad_value in value's dtype, grad_ref like ref_flat or None when
    ``need_ref`` is False, grad_off like off_flat, grad_attn like
    attn_flat; f32). d off and d attn are summed over the cameras that
    share them; grad_value is accumulated in an f32 scratch and cast once."""
    global launches_bwd_factored
    if value.device.type != "cuda":
        raise ValueError(f"msda_bwd_factored launches on CUDA tensors, got {value.device}")
    shapes_ = _factored_shapes(value, spatial_shapes, ref_flat, attn_flat)
    B, V, H, D, Q, L, P, Bs = shapes_
    _check_factored(value, ref_flat, off_flat, attn_flat, tile_mask, q_tile,
                    shapes_)
    dev = value.device
    _check("grad_out", grad_out, (B, Q, H * D), (value.dtype,), dev)
    lib = _lib(BWD_SOURCE)
    grad_value_f32 = torch.empty((B, V, H, D), dtype=torch.float32, device=dev)
    grad_value = (grad_value_f32 if value.dtype == torch.float32
                  else torch.empty_like(value))
    grad_ref = torch.empty_like(ref_flat) if need_ref else None
    grad_off = torch.empty_like(off_flat)
    grad_attn = torch.empty_like(attn_flat)
    shapes = (ctypes.c_int * (2 * L))(*[int(s) for hw in spatial_shapes for s in hw])
    private_from = factored_bwd_plan(spatial_shapes, D, P)
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = (ctypes.c_int * 1)(-1)
    err = lib.msda_bwd_factored(
        value.data_ptr(), _DTYPES[value.dtype], ref_flat.data_ptr(),
        off_flat.data_ptr(), attn_flat.data_ptr(),
        tile_mask.data_ptr() if tile_mask is not None else None,
        grad_out.data_ptr(), grad_value_f32.data_ptr(), grad_value.data_ptr(),
        grad_ref.data_ptr() if grad_ref is not None else None,
        grad_off.data_ptr(), grad_attn.data_ptr(), B, B // Bs, V, H, D, Q, L,
        P, shapes, q_tile, private_from, stream, variant)
    if err != 0:
        raise RuntimeError(f"msda_bwd_factored kernel launch failed: CUDA error {err}")
    launches_bwd_factored += 1
    if variant[0] in BWD_FACTORED_VARIANTS:  # an empty call launches nothing
        launches_bwd_factored_by_variant[BWD_FACTORED_VARIANTS[variant[0]]] += 1
    return grad_value, grad_ref, grad_off, grad_attn


# ------------------------------------------------------------ local entry

def local_halo_rows(tile: Tuple[int, int]) -> int:
    """Cells of a tile's largest halo: the (rows, columns) tile grown by
    LOCAL_HALO a side (csrc/msda_common.cuh local_halo_rows); a halo at the
    map's edge is clipped to the map and holds fewer."""
    return (tile[0] + 2 * LOCAL_HALO) * (tile[1] + 2 * LOCAL_HALO)


def local_tiles(h: int, w: int, tile: Tuple[int, int]) -> Tuple[int, int]:
    """(tile rows, tile columns) of an h x w map: the grid of a batch
    element and head (csrc msda_fwd_local / msda_bwd_local)."""
    return (h + tile[0] - 1) // tile[0], (w + tile[1] - 1) // tile[1]


def local_tile_cells(h: int, w: int, tile: Tuple[int, int], ty: int,
                     tx: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The cells of tile (ty, tx), ((y0, y1), (x0, x1)), and its staged
    halo, ((hy0, hy1), (hx0, hx1)): the tile grown by LOCAL_HALO a side and
    clipped to the map (csrc/msda_common.cuh local_tile)."""
    y0, x0 = ty * tile[0], tx * tile[1]
    y1, x1 = min(h, y0 + tile[0]), min(w, x0 + tile[1])
    halo = ((max(0, y0 - LOCAL_HALO), min(h, y1 + LOCAL_HALO)),
            (max(0, x0 - LOCAL_HALO), min(w, x1 + LOCAL_HALO)))
    return ((y0, y1), (x0, x1)), halo


def local_lanes(D: int) -> int:
    """Lanes that take a query in the tile-local kernels: D / 4 rounded up
    to a power of two (csrc/msda_bwd.cu local_lanes)."""
    return 1 if D <= 4 else 2 if D <= 8 else 4 if D <= 16 else 8


def local_fwd_smem(D: int, P: int) -> int:
    """Shared memory of a msda_fwd_local block (csrc/msda_fwd.cu
    local_fwd_smem): the largest halo's rows of D f32 channels and a row of
    zeros, and each warp's round of 32 / lanes queries' P samples, 56 bytes
    a sample (corner codes and weights, and two buffers of locations and
    weights)."""
    rounds = LOCAL_THREADS // 32 * (32 // local_lanes(D)) * P
    return (local_halo_rows(LOCAL_FWD_TILE) + 1) * D * 4 + rounds * 56


def local_bwd_smem(D: int, P: int) -> int:
    """Shared memory of a msda_bwd_local block (csrc/msda_bwd.cu
    local_bwd_layout): the largest halo's value rows and a row of zeros and
    the tile's grad_out rows in f32, 4 bytes for each of the tile's P·4
    corners a query (weight), one region for the warps' rounds (16 bytes a
    sample) or the row-sorted list (2 bytes a corner), whichever is larger,
    two buffers of the rounds' locations and weights (12 bytes a sample),
    two ints for each halo row (start, cursor) plus the list's end, and 2
    bytes a corner (halo row key)."""
    nh = local_halo_rows(LOCAL_BWD_TILE)
    nq = LOCAL_BWD_TILE[0] * LOCAL_BWD_TILE[1]
    slots = nq * P * 4
    rounds = LOCAL_THREADS // 32 * (32 // local_lanes(D)) * P
    region = (max(slots * 2, rounds * 16) + 15) // 16 * 16
    return ((nh + 1 + nq) * D * 4 + slots * 4 + region + rounds * 24
            + (2 * nh + 1) * 4 + slots * 2)


def check_local(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                sampling_locations: torch.Tensor,
                attention_weights: torch.Tensor,
                grad_out: Optional[torch.Tensor] = None,
                backward: bool = False) -> Tuple[int, ...]:
    """The tile-local entries' contract, checked on shapes and dtypes only
    (no device is touched): one level, the queries its cells (Q = V = h·w),
    f32 value, locations and weights (and grad_out), D in LOCAL_WIDTHS, and
    for the backward (``grad_out`` given, or ``backward``: a forward whose
    gradients will be taken) a block's slots and shared memory within
    LOCAL_BWD_MAX_SLOTS and LOCAL_MAX_SMEM. Returns (B, h, w, H, D, P);
    raises ValueError or TypeError on what the kernels do not take."""
    if value.dim() != 4 or sampling_locations.dim() != 6:
        raise ValueError("value must be (B, V, H, D), locations (B, Q, H, L, P, 2)")
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if L != 1 or len(spatial_shapes) != 1:
        raise ValueError(f"the local entry takes one level, got L={L}, "
                         f"spatial_shapes {spatial_shapes}")
    (h, w), = spatial_shapes
    if h * w != V or Q != V:
        raise ValueError(f"the local entry's queries are the cells of its "
                         f"{h}x{w} map: V={V}, Q={Q}")
    for name, t in (("value", value), ("sampling_locations", sampling_locations),
                    ("attention_weights", attention_weights),
                    ("grad_out", grad_out)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"the local entry takes f32, {name} is {t.dtype}")
    if D not in LOCAL_WIDTHS:
        raise ValueError(f"the local entry takes D in {LOCAL_WIDTHS}, got {D}")
    if local_fwd_smem(D, P) > LOCAL_MAX_SMEM:
        raise ValueError(f"msda_fwd_local's block takes {LOCAL_MAX_SMEM} "
                         f"bytes of shared memory at most: P={P} needs more")
    if (backward or grad_out is not None) and (
            LOCAL_BWD_TILE[0] * LOCAL_BWD_TILE[1] * P * 4 > LOCAL_BWD_MAX_SLOTS
            or local_bwd_smem(D, P) > LOCAL_MAX_SMEM):
        raise ValueError(f"msda_bwd_local takes at most "
                         f"{LOCAL_BWD_MAX_SLOTS} corners a tile and "
                         f"{LOCAL_MAX_SMEM} bytes a block, got P={P}")
    dev = value.device
    _check("value", value, (B, V, H, D), (torch.float32,), dev)
    _check("sampling_locations", sampling_locations, (B, Q, H, 1, P, 2),
           (torch.float32,), dev)
    _check("attention_weights", attention_weights, (B, Q, H, 1, P),
           (torch.float32,), dev)
    if grad_out is not None:
        _check("grad_out", grad_out, (B, Q, H * D), (torch.float32,), dev)
    return B, h, w, H, D, P


def _check_cuda_aligned(name, *tensors):
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {tensors[0].device}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} takes 16-byte aligned rows")


def msda_fwd_local(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """The tile-local MSDA forward: value (B, h·w, H, D) f32, loc
    (B, h·w, H, 1, P, 2) f32, attn (B, h·w, H, 1, P) f32, the queries the
    cells of the one (h, w) level -> (B, h·w, H·D) f32."""
    global launches_local
    B, h, w, H, D, P = check_local(value, spatial_shapes, sampling_locations,
                                   attention_weights)
    _check_cuda_aligned("msda_fwd_local", value)
    lib = _lib()
    out = torch.empty((B, h * w, H * D), dtype=torch.float32, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_fwd_local(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), B, h, w, H, D, P, stream)
    if err != 0:
        raise RuntimeError(f"msda_fwd_local kernel launch failed: CUDA error {err}")
    launches_local += 1
    return out


def msda_bwd_local(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``msda_fwd_local`` at (value, loc, attn) for
    ``grad_out`` (B, h·w, H·D) f32 -> (grad_value like value, grad_loc like
    loc, grad_attn like attn), all f32; grad_value is summed by f32
    atomics (per halo row and block, and per corner outside the halo), in
    an order that varies from run to run."""
    global launches_bwd_local
    B, h, w, H, D, P = check_local(value, spatial_shapes, sampling_locations,
                                   attention_weights, grad_out)
    _check_cuda_aligned("msda_bwd_local", value, grad_out)
    lib = _lib(BWD_SOURCE)
    grad_value = torch.empty_like(value)
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_bwd_local(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), grad_out.data_ptr(),
        grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(),
        B, h, w, H, D, P, stream)
    if err != 0:
        raise RuntimeError(f"msda_bwd_local kernel launch failed: CUDA error {err}")
    launches_bwd_local += 1
    return grad_value, grad_loc, grad_attn


# --------------------------------------------------------- resident entry

# the map-resident entries (csrc/msda_common.cuh kResidentMapBytes,
# kResidentThreads, kResidentMaxPoints): the bytes of a block's staged map,
# a block's threads and the most samples a head; the head widths they take
# (D = 4 G, G lanes of 4 channels an item or a sample)
RESIDENT_MAP_BYTES = 48 * 1024
RESIDENT_THREADS = 256
RESIDENT_MAX_POINTS = 128
RESIDENT_WIDTHS = (4, 8, 16, 32)


def resident_heads(V: int, H: int, D: int) -> int:
    """Heads Hb a block of the resident entries stages (csrc/
    msda_common.cuh resident_heads): the largest divisor of H whose maps,
    V·Hb rows of D f32 channels, take at most RESIDENT_MAP_BYTES; 0 when
    not even one head's does."""
    for hb in range(H, 0, -1):
        if H % hb == 0 and V * hb * D * 4 <= RESIDENT_MAP_BYTES:
            return hb
    return 0


def resident_smem(V: int, H: int, D: int) -> int:
    """Shared memory of a block of either resident entry (csrc/msda_fwd.cu
    resident_fwd_smem, csrc/msda_bwd.cu resident_bwd_smem): the head
    group's map and a row of zeros."""
    return (V * resident_heads(V, H, D) + 1) * D * 4


def takes_resident(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor) -> bool:
    """Whether ``ops.msda.ms_deform_attn`` sends a call to the resident
    entries: f32 value over one level, D in RESIDENT_WIDTHS, rows 16-byte
    aligned (not asked of meta tensors), at most RESIDENT_MAX_POINTS
    samples a head and at least one head's map within RESIDENT_MAP_BYTES;
    with or without a tile mask."""
    if value.dim() != 4 or sampling_locations.dim() != 6:
        return False
    B, V, H, D = value.shape
    L, P = sampling_locations.shape[3], sampling_locations.shape[4]
    return (value.dtype == torch.float32 and L == 1 and len(spatial_shapes) == 1
            and D in RESIDENT_WIDTHS and P <= RESIDENT_MAX_POINTS
            and (value.device.type == "meta" or value.data_ptr() % 16 == 0)
            and resident_heads(V, H, D) >= 1)


def check_resident(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   tile_mask: Optional[torch.Tensor], q_tile: int,
                   grad_out: Optional[torch.Tensor] = None) -> Tuple[int, ...]:
    """The resident entries' contract, checked on shapes and dtypes only (no
    device is touched): one level, f32 value, locations and weights (and
    grad_out), ``takes_resident``'s widths, samples and map budget, an
    int32 tile mask (B, ceil(Q / q_tile)) or none. Returns (B, h, w, H, D, Q, P);
    raises ValueError or TypeError on what the kernels do not take."""
    if value.dim() != 4 or sampling_locations.dim() != 6:
        raise ValueError("value must be (B, V, H, D), locations (B, Q, H, L, P, 2)")
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if L != 1 or len(spatial_shapes) != 1:
        raise ValueError(f"the resident entry takes one level, got L={L}, "
                         f"spatial_shapes {spatial_shapes}")
    (h, w), = spatial_shapes
    if h * w != V:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match V={V}")
    for name, t in (("value", value), ("sampling_locations", sampling_locations),
                    ("attention_weights", attention_weights),
                    ("grad_out", grad_out)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"the resident entry takes f32, {name} is {t.dtype}")
    if D not in RESIDENT_WIDTHS:
        raise ValueError(f"the resident entry takes D in {RESIDENT_WIDTHS}, got {D}")
    if P > RESIDENT_MAX_POINTS:
        raise ValueError(f"the resident entry takes at most "
                         f"{RESIDENT_MAX_POINTS} samples a head, got P={P}")
    if resident_heads(V, H, D) < 1:
        raise ValueError(f"the resident entry stages a head's map within "
                         f"{RESIDENT_MAP_BYTES} bytes: V={V}, D={D} needs "
                         f"{V * D * 4}")
    dev = value.device
    _check("value", value, (B, V, H, D), (torch.float32,), dev)
    _check("sampling_locations", sampling_locations, (B, Q, H, 1, P, 2),
           (torch.float32,), dev)
    _check("attention_weights", attention_weights, (B, Q, H, 1, P),
           (torch.float32,), dev)
    if tile_mask is not None:
        _check("tile_mask", tile_mask, (B, (Q + q_tile - 1) // q_tile),
               (torch.int32,), dev)
    if grad_out is not None:
        _check("grad_out", grad_out, (B, Q, H * D), (torch.float32,), dev)
    return B, h, w, H, D, Q, P


def msda_fwd_resident(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    *,
    tile_mask: Optional[torch.Tensor] = None,
    q_tile: int = 32,
) -> torch.Tensor:
    """The map-resident MSDA forward: value (B, h·w, H, D) f32, loc
    (B, Q, H, 1, P, 2) f32, attn (B, Q, H, 1, P) f32, tile_mask
    (B, ceil(Q / q_tile)) int32 or None -> (B, Q, H·D) f32 (a masked tile's
    queries zero)."""
    global launches_resident
    B, h, w, H, D, Q, P = check_resident(value, spatial_shapes,
                                         sampling_locations,
                                         attention_weights, tile_mask, q_tile)
    _check_cuda_aligned("msda_fwd_resident", value)
    lib = _lib()
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_fwd_resident(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(),
        tile_mask.data_ptr() if tile_mask is not None else None,
        out.data_ptr(), B, h, w, H, D, Q, P, q_tile, stream)
    if err != 0:
        raise RuntimeError(f"msda_fwd_resident kernel launch failed: CUDA error {err}")
    launches_resident += 1
    return out


def msda_bwd_resident(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    tile_mask: Optional[torch.Tensor] = None,
    q_tile: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``msda_fwd_resident`` at (value, loc, attn) for
    ``grad_out`` (B, Q, H·D) f32 -> (grad_value like value, grad_loc like
    loc, grad_attn like attn), all f32, those of a masked tile's queries
    zero; grad_value is summed by 16-byte f32 atomics (a corner's row at a
    time), in an order that varies from run to run."""
    global launches_bwd_resident
    B, h, w, H, D, Q, P = check_resident(value, spatial_shapes,
                                         sampling_locations,
                                         attention_weights, tile_mask, q_tile,
                                         grad_out)
    _check_cuda_aligned("msda_bwd_resident", value, grad_out)
    lib = _lib(BWD_SOURCE)
    grad_value = torch.empty_like(value)
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = lib.msda_bwd_resident(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(),
        tile_mask.data_ptr() if tile_mask is not None else None,
        grad_out.data_ptr(), grad_value.data_ptr(), grad_loc.data_ptr(),
        grad_attn.data_ptr(), B, h, w, H, D, Q, P, q_tile, stream)
    if err != 0:
        raise RuntimeError(f"msda_bwd_resident kernel launch failed: CUDA error {err}")
    launches_bwd_resident += 1
    return grad_value, grad_loc, grad_attn
