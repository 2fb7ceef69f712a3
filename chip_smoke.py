"""Smoke run of the PyTorch/H100 port on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one NVIDIA GPU, nvcc (PATH or /usr/local/cuda/bin) and this checkout.

Phases, each printing one JSON line:
  env      card name and power limit (nvidia-smi), torch and CUDA versions.
  build    builds the MSDA kernel from csrc/ and prints the build seconds.
  kernels  the CUDA MSDA kernel against its plain PyTorch version at the
           flagship's four call shapes (TSA, SCA with a tile mask from the
           camera-ring geometry, det decoder, map decoder) in f32 and bf16:
           max abs error, kernel / plain time (CUDA events), and the bound.
  stream   the flagship bev_tiny_det_map_apollo at full width (6 cams at
           480x800, 50x50 BEV, 3 encoder + 6 det + 6 map decoder layers,
           random weights from a seed) through the streaming runner: frames
           with can_bus deltas and one scene change, launch counts per frame,
           finite outputs, one f32 frame held against the CPU plain path,
           and steady-state frames/s as configured (bf16) and in f32.
Then the ``{"kernels": [...]}`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from apollo_vision_net_tpu_torch.configs import bev_tiny_det_map_apollo
from apollo_vision_net_tpu_torch.data.synthetic import (
    camera_ring_lidar2img,
    make_stream,
)
from apollo_vision_net_tpu_torch.data.temporal import StreamingState
from apollo_vision_net_tpu_torch.models.detector import build_model
from apollo_vision_net_tpu_torch.ops import msda_cuda
from apollo_vision_net_tpu_torch.ops.msda import (
    materialize_factored,
    ms_deform_attn_ref,
)
from apollo_vision_net_tpu_torch.runtime.inference import (
    StreamingRunner,
    last_layer,
)
from apollo_vision_net_tpu_torch.utils import geometry

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and f32 rate
# outside the tensor cores. MSDA's arithmetic is f32 FMAs on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# kernel vs plain: f32 differs only in summation order; bf16 rounds the same
# f32 sum to bf16 in both, which may land one bf16 ulp apart (2^-7 at |x|<2)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# one f32 frame on the GPU against the CPU plain path: different conv and
# matmul algorithms and summation orders through ~60 layers; error relative
# to each output's largest magnitude
STREAM_REL_TOL = 2e-3
KERNEL_SOURCE = "apollo_vision_net_tpu_torch/csrc/msda_fwd.cu"
REPLACES = {
    "msda_fwd": ("apollo_vision_net_tpu/ops/msda_pallas.py:194 (_msda_kernel); "
                 "apollo_vision_net_tpu/ops/msda_pallas.py:234 "
                 "(_msda_kernel_slab, TSA use)"),
    "msda_fwd_masked": ("apollo_vision_net_tpu/ops/msda_pallas.py:234 "
                        "(_msda_kernel_slab with tile mask, SCA use)"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, warmup: int = 10, iters: int = 100) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 50) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so host launch cost (Python, the wrapper's checks, ctypes)
    is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------- kernels

def _case(name, g, dev, *, B, hw, H, D, Q, P, ref_xy, tile_mask=None):
    """Inputs of one MSDA call: ref_xy (B, Q, P, 2) normalized reference
    points per point, offsets of ~2 cells, softmaxed weights."""
    h, w = hw
    value = torch.randn((B, h * w, H, D), generator=g, device=dev)
    off = torch.randn((B, Q, H, 1, P, 2), generator=g, device=dev) * 2.0
    off = off / torch.tensor([w, h], device=dev, dtype=torch.float32)
    loc = (ref_xy[:, :, None, None] + off).contiguous()
    attn = torch.softmax(
        torch.randn((B, Q, H, P), generator=g, device=dev), -1
    ).reshape(B, Q, H, 1, P).contiguous()
    return dict(name=name, value=value, shapes=((h, w),), loc=loc, attn=attn,
                tile_mask=tile_mask)


def flagship_cases(dev):
    """The four MSDA call shapes of one flagship frame."""
    cfg = bev_tiny_det_map_apollo()
    m = cfg.model
    g = torch.Generator(device=dev).manual_seed(0)
    bh, bw = m.bev_h, m.bev_w
    Q = bh * bw
    fh, fw = m.img_shape[0] // 16, m.img_shape[1] // 16
    N, H, D = m.num_cams, 8, m.embed_dims // 8
    cases = []
    # TSA: 2-slot queue folded into the batch, refs on the BEV grid
    ref2d = torch.as_tensor(geometry.bev_reference_points_2d(bh, bw), device=dev)
    cases.append(_case("tsa", g, dev, B=2, hw=(bh, bw), H=H, D=D, Q=Q, P=4,
                       ref_xy=ref2d[None, :, None].expand(2, Q, 4, 2)))
    # SCA: pillar points projected into the camera ring, queries in 8x4
    # blocks, tiles of 32 masked by visibility (as SpatialCrossAttention)
    ref3d = torch.as_tensor(geometry.bev_reference_points_3d(
        bh, bw, m.pc_range[5] - m.pc_range[2], m.num_points_in_pillar),
        device=dev)
    l2i = torch.as_tensor(camera_ring_lidar2img(N, *m.img_shape), device=dev)
    ref_cam, bev_mask = geometry.point_sampling(
        ref3d, m.pc_range, l2i[None], m.img_shape)
    perm, _ = geometry.spatial_block_order(bh, bw, 8, 4)
    perm = torch.as_tensor(perm, device=dev, dtype=torch.int64)
    ref_cam = ref_cam[0][:, perm]                      # (N, Q, Dz, 2)
    hit = bev_mask[0].any(-1)[:, perm]                 # (N, Q)
    qt = 32
    n_tiles = (Q + qt - 1) // qt
    hit_pad = torch.nn.functional.pad(hit, (0, n_tiles * qt - Q))
    tile_mask = hit_pad.reshape(N, n_tiles, qt).any(-1).to(torch.int32)
    P = 8
    ref_flat = ref_cam.reshape(N, Q, -1).repeat(1, 1, P // ref_cam.shape[2])
    off = torch.randn((1, Q, H * P * 2), generator=g, device=dev) * 2.0
    attn = torch.softmax(torch.randn((1, Q, H, P), generator=g, device=dev), -1)
    loc, attn = materialize_factored(ref_flat, off, attn.reshape(1, Q, -1),
                                     ((fh, fw),), H, P)
    cases.append(dict(
        name="sca", value=torch.randn((N, fh * fw, H, D), generator=g, device=dev),
        shapes=((fh, fw),), loc=loc.reshape(N, Q, H, 1, P, 2).contiguous(),
        attn=attn.reshape(N, Q, H, 1, P).contiguous(), tile_mask=tile_mask))
    # det and map decoders: queries at random reference points on the BEV
    for name, nq in (("det_decoder", m.num_query),
                     ("map_decoder", m.num_map_vec * m.map_num_pts)):
        ref = torch.rand((1, nq, 1, 2), generator=g, device=dev)
        cases.append(_case(name, g, dev, B=1, hw=(bh, bw), H=H, D=D, Q=nq, P=4,
                           ref_xy=ref.expand(1, nq, 4, 2)))
    return cases


def edge_cases(dev):
    """Small shapes the flagship does not reach: D < 32 and D > 32, two
    levels, Q not a multiple of the tile, locations outside the grid."""
    g = torch.Generator(device=dev).manual_seed(1)
    out = []
    for (B, H, D, Q, P, shapes) in ((2, 4, 4, 37, 5, ((6, 9), (3, 5))),
                                    (1, 2, 40, 70, 3, ((7, 5),))):
        V = sum(h * w for h, w in shapes)
        L = len(shapes)
        value = torch.randn((B, V, H, D), generator=g, device=dev)
        loc = torch.rand((B, Q, H, L, P, 2), generator=g, device=dev) * 1.4 - 0.2
        attn = torch.rand((B, Q, H, L, P), generator=g, device=dev)
        n_tiles = (Q + 31) // 32
        tm = (torch.rand((B, n_tiles), generator=g, device=dev) > 0.4).to(torch.int32)
        out.append(dict(name=f"edge_D{D}", value=value, shapes=shapes, loc=loc,
                        attn=attn, tile_mask=None))
        out.append(dict(name=f"edge_D{D}_masked", value=value, shapes=shapes,
                        loc=loc, attn=attn, tile_mask=tm))
    return out


def bound(case, value):
    """Least time for the call: each input read once (loc/attn of active
    tiles only), the output written once; 4 corners x D FMAs per sample."""
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = case["loc"].shape
    tm = case["tile_mask"]
    active_q = Q * B
    if tm is not None:
        qt = 32
        per_tile = torch.full((tm.shape[1],), qt, device=tm.device)
        per_tile[-1] = Q - qt * (tm.shape[1] - 1)
        active_q = int((tm.to(torch.int64) * per_tile).sum())
    elem = value.element_size()
    nbytes = (value.numel() * elem + active_q * H * L * P * (2 + 1) * 4
              + B * Q * H * D * elem)
    ops = active_q * H * L * P * (4 * 2 * D)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev):
    rows = []
    for case in flagship_cases(dev) + edge_cases(dev):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            value = case["value"].to(dtype).contiguous()
            args = (value, case["shapes"], case["loc"], case["attn"])
            kw = dict(tile_mask=case["tile_mask"], q_tile=32)
            got = msda_cuda.msda_fwd(*args, **kw)
            torch.cuda.synchronize()
            want = ms_deform_attn_ref(*args, **kw)
            err = float((got.float() - want.float()).abs().max())
            finite = bool(torch.isfinite(got).all())
            row = dict(case=case["name"], dtype=dname, max_abs_err=err,
                       tol=TOL[dname], finite=finite)
            if not case["name"].startswith("edge"):
                def kernel():
                    return msda_cuda.msda_fwd(*args, **kw)

                def plain():
                    return ms_deform_attn_ref(*args, **kw)

                # ms / plain_ms: device time (CUDA graph replay);
                # call_ms: an eager call as the main path makes it
                row["ms"] = graph_time_ms(kernel)
                row["plain_ms"] = graph_time_ms(plain, iters=10)
                row["call_ms"] = time_ms(kernel)
                row["bound_ms"], row["bound_by"] = bound(case, value)
                if case["tile_mask"] is not None:
                    row["active_tiles"] = int(case["tile_mask"].sum())
                    row["tiles"] = int(case["tile_mask"].numel())
            rows.append(row)
            emit({"phase": "kernels", **row})
            if not finite or err > TOL[dname]:
                raise AssertionError(f"kernel disagrees with plain: {row}")
    msda_cuda.reset_launch_counts()
    return rows


# ----------------------------------------------------------------- stream

def _frame_to(frame, dev):
    out = dict(frame)
    for k in ("img", "lidar2img"):
        out[k] = torch.as_tensor(frame[k]).to(dev)
    return out


def _rel_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def phase_stream(dev):
    cfg = bev_tiny_det_map_apollo()
    cfg32 = dataclasses.replace(
        cfg, compute_dtype="float32",
        model=dataclasses.replace(cfg.model, transformer_dtype="float32"))
    n_frames = 6
    frames = [_frame_to(f, dev) for f in
              make_stream(cfg, n_frames, seed=1, scene_change_at=(3,))]
    model = build_model(cfg, device=dev, seed=0)

    # the main path: counts set to 0 just before, read just after
    runner = StreamingRunner(cfg, model)
    msda_cuda.reset_launch_counts()
    results = [runner.step(f) for f in frames]
    torch.cuda.synchronize()
    launches = {"msda_fwd": msda_cuda.launches_plain,
                "msda_fwd_masked": msda_cuda.launches_masked}
    finite = all(bool(torch.isfinite(t.float()).all())
                 for r in results for t in r["outs"].values())
    has_prev = [r["has_prev"] for r in results]
    emit({"phase": "stream", "frames": n_frames, "launches": launches,
          "per_frame": {k: v / n_frames for k, v in launches.items()},
          "finite": finite, "has_prev": has_prev,
          "dets_valid": [int(r["det"].valid.sum()) for r in results]})
    # per frame: TSA in every encoder layer and cross-attention in every det
    # and map decoder layer (15 at the flagship), SCA per encoder layer (3)
    m = cfg.model
    expect = {"msda_fwd": (m.encoder_layers + m.decoder_layers
                           + m.map_decoder_layers) * n_frames,
              "msda_fwd_masked": m.encoder_layers * n_frames}
    if launches != expect:
        raise AssertionError(f"launches {launches} != expected {expect}")
    if not finite or has_prev != [0.0, 1.0, 1.0, 0.0, 1.0, 1.0]:
        raise AssertionError("non-finite outputs or wrong scene resets")

    # one f32 frame with history (frame 1 after frame 0) on the GPU against
    # the CPU plain path, same weights and inputs
    state = model.state_dict()
    model32 = build_model(cfg32, device=dev, seed=0)
    model32.load_state_dict(state)
    cpu32 = build_model(cfg32, device="cpu", seed=0)
    cpu32.load_state_dict(state)
    stream_state = StreamingState()
    deltas = []
    for f in frames[:2]:
        deltas.append(stream_state.prepare_frame(f["can_bus"], f["scene_token"]))
        stream_state.update(True)

    def frame_step(mdl, d, f, delta, prev):
        cb, hp = delta
        with torch.inference_mode():
            outs, new_prev = mdl.forward_test_frame(
                f["img"].to(d)[None], torch.as_tensor(cb, device=d)[None],
                f["lidar2img"].to(d)[None], prev,
                torch.full((1,), hp, device=d))
        return last_layer(outs), new_prev

    Q = cfg.model.bev_h * cfg.model.bev_w
    _, prev = frame_step(model32, dev, frames[0], deltas[0],
                         torch.zeros((1, Q, cfg.model.embed_dims), device=dev))
    gpu, _ = frame_step(model32, dev, frames[1], deltas[1], prev)
    t0 = time.perf_counter()
    cpu, _ = frame_step(cpu32, "cpu", frames[1], deltas[1], prev.cpu())
    cpu_s = time.perf_counter() - t0
    errs = {k: _rel_err(gpu[k], cpu[k]) for k in gpu}
    emit({"phase": "stream_f32_vs_cpu", "has_prev": deltas[1][1],
          "rel_err": errs, "tol": STREAM_REL_TOL, "cpu_frame_s": cpu_s})
    if deltas[1][1] != 1.0 or max(errs.values()) > STREAM_REL_TOL:
        raise AssertionError(f"GPU f32 frame disagrees with the CPU: {errs}")

    # steady-state frames/s: warm frames, then CUDA events around 20 frames
    fps = {}
    for name, c, mdl in (("bf16", cfg, model), ("f32", cfg32, model32)):
        run = StreamingRunner(c, mdl)
        stream = frames * 4
        for f in stream[:3]:
            run.step(f)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for f in stream[3:23]:
            run.step(f)
        end.record()
        torch.cuda.synchronize()
        fps[name] = 20 / (start.elapsed_time(end) / 1e3)
    emit({"phase": "stream_fps", "frames_per_s": fps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for name, c, mdl in (("bf16", cfg, model), ("f32", cfg32, model32)):
        profile_frames(name, c, mdl, frames, 1e3 / fps[name])
    return launches


def profile_frames(name, cfg, model, frames, frame_ms):
    """torch.profiler over 4 warm frames: device busy time per frame (sum
    of kernel durations), kernels per frame and the top kernels by device
    time; idle share against the unprofiled frame time ``frame_ms``."""
    from torch.profiler import ProfilerActivity, profile

    run = StreamingRunner(cfg, model)
    for f in frames[:2]:
        run.step(f)
    torch.cuda.synchronize()
    n = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames[2:2 + n]:
            run.step(f)
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        emit({"phase": "profile", "dtype": name, "device_time": "not measured"})
        return
    by_name = {}
    for e in kern:
        k = e.name[:80]
        t, c = by_name.get(k, (0.0, 0))
        by_name[k] = (t + e.time_range.elapsed_us(), c + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": "profile", "dtype": name, "frames": n,
          "device_busy_ms_per_frame": busy_ms,
          "kernels_per_frame": len(kern) / n,
          "frame_ms_unprofiled": frame_ms,
          "device_idle_share": 1.0 - busy_ms / frame_ms,
          "top": [{"name": k, "ms_per_frame": t / 1e3 / n, "calls_per_frame": c / n}
                  for k, (t, c) in top]})


def kernels_line(rows, launches):
    """One entry per kernel entry point; times are the per-frame sums of its
    flagship calls in bf16 (the configured dtype)."""
    calls = {"msda_fwd": {"tsa": 3, "det_decoder": 6, "map_decoder": 6},
             "msda_fwd_masked": {"sca": 3}}
    out = []
    for name, mix in calls.items():
        sel = [r for r in rows if r["case"] in mix]
        bf = [r for r in sel if r["dtype"] == "bfloat16"]
        entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                 "replaces": REPLACES[name],
                 "launches": launches[name],
                 "max_abs_err": max(r["max_abs_err"] for r in bf),
                 "max_abs_err_f32": max(r["max_abs_err"] for r in sel
                                        if r["dtype"] == "float32")}
        for key in ("ms", "plain_ms", "bound_ms", "call_ms"):
            entry[key] = sum(r[key] * mix[r["case"]] for r in bf)
        entry["bound_by"] = "bytes" if all(
            r["bound_by"] == "bytes" for r in bf) else "operations"
        entry["library_ms"] = None
        entry["per_frame_calls"] = mix
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    msda_cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": KERNEL_SOURCE})
    rows = phase_kernels(dev)
    launches = phase_stream(dev)
    emit(kernels_line(rows, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
