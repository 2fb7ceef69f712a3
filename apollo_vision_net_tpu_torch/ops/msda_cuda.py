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
them by the kernel variant that ran: ``vector`` (16-byte gathers, D *
element size a power-of-two multiple of 16 bytes, aligned rows) or
``general`` (scalar channels, any D). ``launches_bwd_plain`` and
``launches_bwd_masked`` count the backward's launches without and with a
tile mask, and ``launches_bwd_plain_by_variant`` /
``launches_bwd_masked_by_variant`` split them by the plan that ran
(``BWD_VARIANTS``, chosen by ``bwd_plan``): ``gather`` (the vector
kernel, several items a warp, pushing each corner onto its row's lists,
then a pass over the rows that sums them and writes grad_value in value's
dtype) or ``general`` (any head width or alignment: a warp per item, f32
atomics into a scratch). ``launches_bwd_factored``
counts the factored backward's launches and
``launches_bwd_factored_by_variant`` splits them by
``BWD_FACTORED_VARIANTS``: ``privatized`` (the vector kernel with the
grad_value rows of the coarsest levels summed in shared memory, as
``factored_bwd_plan`` chooses), ``vector`` (the same kernel with no level
small enough) or ``general``.

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
# the C entry reports the variant it launched: 1 vector, 0 general
VARIANTS = {1: "vector", 0: "general"}
launches_plain_by_variant = dict.fromkeys(VARIANTS.values(), 0)
launches_masked_by_variant = dict.fromkeys(VARIANTS.values(), 0)
launches_factored_by_variant = dict.fromkeys(VARIANTS.values(), 0)
BWD_VARIANTS = {1: "gather", 0: "general"}
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
}
# the source of each entry point
ENTRY_SOURCE = {"msda_fwd": SOURCE, "msda_fwd_factored": SOURCE,
                "msda_bwd": BWD_SOURCE, "msda_bwd_factored": BWD_SOURCE}


def reset_launch_counts() -> None:
    global launches_plain, launches_masked, launches_factored
    global launches_bwd_plain, launches_bwd_masked, launches_bwd_factored
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
    """Whether value and grad_out start on a 4-channel boundary, as
    msda_bwd's vector kernel loads them."""
    align = 4 * value.element_size()
    return value.data_ptr() % align == 0 and grad_out.data_ptr() % align == 0


def bwd_gather_scratch(B: int, V: int, H: int, Q: int, lp: int) -> dict:
    """int32 elements of the gather plan's lists: a head for each value
    row (``row_head``, B·V·H) and a (link, weight) pair for each corner of
    each sample (``slot_links``, 2·B·Q·H·L·P·4)."""
    return {"row_head": B * V * H, "slot_links": 2 * B * Q * H * lp * 4}


def bwd_plan(B: int, V: int, H: int, D: int, Q: int, lp: int,
             aligned: bool = True) -> int:
    """The plan of a msda_bwd call (a key of BWD_VARIANTS; the C entry
    refuses one its inputs do not allow): "gather" for D = 4, 8, 16 or 32
    with aligned rows, value offsets and corner slots below 2^31; else
    "general"."""
    ok = (D in BWD_VECTOR_WIDTHS and aligned
          and B * V * H * D <= _INT32_MAX and B * Q * H * lp * 4 <= _INT32_MAX)
    return 1 if ok else 0


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
    row's lists (gather plan) or in an f32 scratch (general)."""
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
