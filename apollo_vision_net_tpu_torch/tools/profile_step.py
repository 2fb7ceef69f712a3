"""Where a streaming frame's time goes, on the card.

Counterpart of the JAX package's tools/profile_step.py (a trace of the
streaming step, its top ops by device time) and tools/bench_stages.py (the
frame split into backbone and neck, encoder, and encoder with decoders).

- ``profile_frames``: torch.profiler over ``n`` warm frames of the
  streaming runner (after 2 unprofiled ones): device busy ms a frame (the
  sum of kernel durations), the idle share against the unprofiled frame
  time, kernels and host synchronizations a frame, and the top kernels by
  device time with their calls. A host synchronization is a call of
  ``SYNC_CALLS``: while the host waits, the device runs dry.
- ``stage_split``: each stage run ``frames`` times on inputs moved by
  i·1e-6, timed with CUDA events after 2 warm runs: ``bb`` the trunk and
  neck (``extract_img_feat``), ``enc`` the encoder from the frame's
  features, ``head`` the encoder, decoders and branches from the features,
  ``full`` the whole frame; the residual ``full - bb - head`` is what the
  frame spends outside them. Each stage's kernel launches a frame come from
  the wrappers' counters.

On a CPU device, which runs only when asked, both report host time (the
profiler's CPU self time by op, and the wall clock of the stages), labelled
as such, and the calls of each plain version a frame (its
``record_function`` range); nothing from a CPU run is a device metric.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.profile_step [config]
      [--top 40] [--frames 4] [--stages full,bb,enc,head] [--device cpu]
"""
from __future__ import annotations

import argparse
import re
import time
from typing import Dict, Sequence

import torch

from apollo_vision_net_tpu_torch import configs

# host calls that wait for the device (a pageable host-to-device copy
# synchronizes the stream): each one lets the device run dry
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
# the plain versions' profiler ranges (ops.msda, ops.dcn)
PLAIN_RANGES = ("ms_deform_attn.plain", "ms_deform_attn_factored.plain",
                "modulated_deform_conv.plain")
STAGES = ("full", "bb", "enc", "head")
WARM = 2


def profile_kernels(prof):
    """A finished torch.profiler window's device kernels as (name, us) and
    its count of SYNC_CALLS, read from the profiler's raw events, as
    ``prof.events()`` would give them but without building its Python
    object per event (that parse took 411 s of a 1,130-s run over 49
    windows, on an H100 host). A user annotation (the optimizer's step
    range) is also a device event, and is not a kernel."""
    kern, syncs = [], 0
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                kern.append((e.name(), (e.end_ns() - e.start_ns()) / 1e3))
        elif e.name() in SYNC_CALLS:
            syncs += 1
    return kern, syncs


def summarize(prof, n: int, unit: str, unit_ms: float, t0: float,
              top: int = 12) -> dict:
    """Device busy time per ``unit`` (sum of kernel durations), kernels and
    host synchronizations per unit, the top kernels by device time and the
    port's own kernels (csrc/: the MSDA and DCN kernels and their bf16 cast)
    whatever their rank; idle share against the unprofiled time
    ``unit_ms``; the host seconds of the window since ``t0``, the
    profiler's event processing included. Without device events:
    ``{"device_time": "not measured"}``."""
    kern, syncs = profile_kernels(prof)
    if not kern:
        return {"device_time": "not measured",
                "seconds": time.perf_counter() - t0}
    by_name = {}
    for kname, us in kern:
        k = kname[:80]
        t, c = by_name.get(k, (0.0, 0))
        by_name[k] = (t + us, c + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3 / n
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    # F.grid_sample on volumes: ops.msda3d (voxel TSA) and the flow warps
    sampler3d = sum(t for k, (t, _) in by_name.items() if "grid_sampler_3d" in k)
    return {unit + "s": n,
            f"device_busy_ms_per_{unit}": busy_ms,
            f"grid_sampler_3d_ms_per_{unit}": sampler3d / 1e3 / n,
            f"kernels_per_{unit}": len(kern) / n,
            f"host_syncs_per_{unit}": syncs / n,
            f"{unit}_ms_unprofiled": unit_ms,
            "device_idle_share": 1.0 - busy_ms / unit_ms,
            "seconds": time.perf_counter() - t0,
            "top": [{"name": k, f"ms_per_{unit}": t / 1e3 / n,
                     f"calls_per_{unit}": c / n} for k, (t, c) in ranked],
            "own_kernels": [{"name": k, f"ms_per_{unit}": t / 1e3 / n,
                             f"calls_per_{unit}": c / n}
                            for k, (t, c) in by_name.items()
                            if re.search(r"\b(msda_|dcn_|cast_bf16_)\w*kernel", k)]}


def summarize_cpu(prof, n: int, unit: str, t0: float, top: int = 12) -> dict:
    """A CPU run's window: the host's self time per ``unit`` by op (CPU
    self time, not a device metric) and the calls of each plain version
    (``PLAIN_RANGES``) per unit."""
    ops = [e for e in prof.key_averages() if e.key not in PLAIN_RANGES]
    ranked = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:top]
    plain = {e.key: e.count / n for e in prof.key_averages()
             if e.key in PLAIN_RANGES}
    return {unit + "s": n,
            f"cpu_self_ms_per_{unit}": sum(e.self_cpu_time_total for e in ops) / 1e3 / n,
            f"plain_calls_per_{unit}": {k: plain.get(k, 0.0) for k in PLAIN_RANGES},
            "seconds": time.perf_counter() - t0,
            "top_cpu_self": [{"name": e.key[:80], f"ms_per_{unit}": e.self_cpu_time_total / 1e3 / n,
                              f"calls_per_{unit}": e.count / n} for e in ranked]}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_frames(cfg, model, frames: Sequence[dict], frame_ms: float = None,
                   n: int = 4, top: int = 12) -> dict:
    """torch.profiler over ``n`` frames of the streaming runner after
    ``WARM`` unprofiled ones (``frames`` holds at least WARM + n):
    ``summarize`` per frame on the card, ``summarize_cpu`` on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner

    if len(frames) < WARM + n:
        raise ValueError(f"{len(frames)} frames: {WARM} warm + {n} profiled needed")
    run = StreamingRunner(cfg, model)
    for f in frames[:WARM]:
        run.step(f)
    _synchronize(run.device)
    cuda = run.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        for f in frames[WARM:WARM + n]:
            run.step(f)
        _synchronize(run.device)
    if cuda:
        return summarize(prof, n, "frame", frame_ms, t0, top)
    return summarize_cpu(prof, n, "frame", t0, top)


def frame_ms(cfg, model, frames: Sequence[dict], n: int) -> float:
    """Unprofiled ms a frame of the streaming runner: ``WARM`` warm frames,
    then CUDA events around ``n`` frames (the host clock on the CPU)."""
    from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner

    run = StreamingRunner(cfg, model)
    stream = list(frames) * (1 + (n + WARM) // len(frames))
    for f in stream[:WARM]:
        run.step(f)
    return _timed(run.device, lambda i: run.step(stream[WARM + i]), n)


def kernel_launches() -> Dict[str, int]:
    """The forward entries' launch counters (``ops.msda_cuda``,
    ``ops.dcn_cuda``): each wrapper adds one where it launches its kernel."""
    from apollo_vision_net_tpu_torch.ops import dcn_cuda, msda_cuda

    return {"msda_fwd": msda_cuda.launches_plain,
            "msda_fwd_masked": msda_cuda.launches_masked,
            "msda_fwd_factored": msda_cuda.launches_factored,
            "msda_fwd_local": msda_cuda.launches_local,
            "msda_fwd_resident": msda_cuda.launches_resident,
            "dcn_fwd": dcn_cuda.launches}


def _timed(device: torch.device, fn, n: int) -> float:
    _synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        return (time.perf_counter() - t0) / n * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n


@torch.inference_mode()
def stage_split(model, frame: dict, stages: Sequence[str] = STAGES,
                frames: int = 4) -> dict:
    """Each stage of ``stages`` (``STAGES``) timed over ``frames`` runs on
    inputs moved by i·1e-6 after ``WARM`` warm runs, with the frame's
    can_bus and has_prev = 1 (bench_stages.py's protocol); the carry goes
    from one run to the next. -> {"clock": "cuda events" or "host (CPU
    run)", "ms_per_frame": {stage: ms}, "launches_per_frame": {stage:
    {entry: calls}}, and "residual_ms": full - bb - head where all three
    ran}."""
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}: take {STAGES}")
    dev = next(model.parameters()).device
    img = torch.as_tensor(frame["img"]).to(dev, torch.float32)[None]
    can_bus = torch.as_tensor(frame["can_bus"]).to(dev, torch.float32)[None]
    lidar2img = torch.as_tensor(frame["lidar2img"]).to(dev, torch.float32)[None]
    has_prev = torch.ones((1,), device=dev)
    carry = {"prev": model.zero_carry(1, dev)}
    feats0 = model.extract_img_feat(img) if {"enc", "head"} & set(stages) else None

    def head(i, **kw):
        feats = tuple(f + i * 1e-6 for f in feats0)
        return model.head(feats, can_bus=can_bus, lidar2img=lidar2img,
                          prev_bev=carry["prev"], has_prev=has_prev, **kw)

    def full(i):
        _, carry["prev"] = model.forward_test_frame(
            img + i * 1e-6, can_bus, lidar2img, carry["prev"], has_prev)

    def bb(i):
        model.extract_img_feat(img + i * 1e-6)

    def enc(i):
        carry["prev"] = head(i, only_bev=True)

    def head_full(i):
        carry["prev"] = head(i)["bev_embed"]

    run = {"full": full, "bb": bb, "enc": enc, "head": head_full}
    out = {"clock": "cuda events" if dev.type == "cuda" else "host (CPU run)",
           "frames": frames, "ms_per_frame": {}, "launches_per_frame": {}}
    for name in stages:
        carry["prev"] = model.zero_carry(1, dev)
        for i in range(WARM):
            run[name](i)
        before = kernel_launches()
        out["ms_per_frame"][name] = _timed(dev, run[name], frames)
        out["launches_per_frame"][name] = {
            k: (v - before[k]) / frames for k, v in kernel_launches().items()}
    ms = out["ms_per_frame"]
    if {"full", "bb", "head"} <= set(ms):
        out["residual_ms"] = ms["full"] - ms["bb"] - ms["head"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", nargs="?", default="bev_tiny_det_map_apollo")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--stages", default=",".join(STAGES),
                   help="comma list of stages to time; '' for none")
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    from apollo_vision_net_tpu_torch import resolve_device
    from apollo_vision_net_tpu_torch.data.synthetic import make_stream
    from apollo_vision_net_tpu_torch.models.detector import build_model

    device = resolve_device(args.device)
    cfg = getattr(configs, args.config)()
    model = build_model(cfg, device)
    frames = make_stream(cfg, WARM + args.frames)
    for f in frames:
        f["img"] = torch.as_tensor(f["img"]).to(device)
    ms = frame_ms(cfg, model, frames, args.frames)
    prof = profile_frames(cfg, model, frames, ms, n=args.frames, top=args.top)
    print(f"config: {cfg.name} on {device}")
    if device.type == "cuda":
        print(f"frame: {ms:.3f} ms unprofiled; device busy "
              f"{prof['device_busy_ms_per_frame']:.3f} ms, idle share "
              f"{prof['device_idle_share']:.3f}, "
              f"{prof['kernels_per_frame']:.1f} kernels, "
              f"{prof['host_syncs_per_frame']:.1f} host syncs a frame")
        for r in prof["top"]:
            print(f"{r['ms_per_frame'] * 1e3:10.1f} us/frame "
                  f"{r['calls_per_frame']:7.1f} calls/frame  {r['name']}")
    else:
        print(f"frame (CPU run, host clock): {ms:.3f} ms; CPU self time "
              f"{prof['cpu_self_ms_per_frame']:.3f} ms a frame")
        print("plain-version calls a frame: " + ", ".join(
            f"{k} {v:g}" for k, v in prof["plain_calls_per_frame"].items()))
        for r in prof["top_cpu_self"]:
            print(f"{r['ms_per_frame'] * 1e3:10.1f} us/frame CPU self "
                  f"{r['calls_per_frame']:7.1f} calls/frame  {r['name']}")
    stages = [s for s in args.stages.split(",") if s]
    if stages:
        split = stage_split(model, frames[-1], stages, args.frames)
        labels = {"full": "full_step", "bb": "backbone+neck",
                  "enc": "encoder (bev)", "head": "encoder+decoders"}
        for name, t in split["ms_per_frame"].items():
            launches = {k: v for k, v in split["launches_per_frame"][name].items() if v}
            print(f"{labels[name]:18s} {t:8.3f} ms/frame ({split['clock']})"
                  + (f"  launches/frame {launches}" if launches else ""))
        if "residual_ms" in split:
            print(f"residual (full - bb - head) ~ {split['residual_ms']:8.3f} ms/frame")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
