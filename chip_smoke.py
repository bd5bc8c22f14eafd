#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``arrow_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases; any failure exits non-zero without the final line:

1. Probe: versions, the card's name and power limit, the build of every
   kernel in ``arrow_tpu_torch/csrc`` (``nvcc`` for ``sm_90a``, into
   ``build/``), and ``self_check()``, which launches the probe kernel.
2. Every kernel against its plain PyTorch version on the card: the grouped
   sum in f64 at Q1's shape (SF10's capacity, 12 slots) and at 512 slots,
   in f32 at 16 slots, and with Inf and NaN groups.
3. The main path: ``self_check()``, ``q1_device_batch(10.0)``,
   ``compile_chain(q1_chain_decls())`` and the download of the result,
   with every launch count set to 0 just before and read just after. The
   result is held against an independent numpy Q1 over the downloaded
   source columns.
4. Times with CUDA events after a warm-up: Q1 rows/s, and each kernel's
   time beside its bound, its plain version's and one library call's.

The line before the last is one JSON object with a record per kernel; the
last is ``{"ok": true, "device": {...}}``. The script imports torch, numpy
and the port only.
"""

from __future__ import annotations

import json
import sys
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
F64_OPS_PER_S = 34e12       # H100 SXM FP64 outside the tensor cores
SF = 10.0
Q1_SLOTS = 12               # (3+1) return flags x (2+1) line statuses
RTOL_F64 = 1e-9             # the atomics reorder f64 additions
RTOL_F32 = 1e-5             # an f32 result against an f64 reference


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name, got, want, rtol):
    """Equal NaN/Inf pattern, finite values within rtol; returns the
    largest absolute error over the finite values."""
    got, want = got.double().cpu(), want.double().cpu()
    nan_ok = torch.equal(torch.isnan(got), torch.isnan(want))
    inf_ok = torch.equal(torch.isinf(got), torch.isinf(want)) and \
        torch.equal(got[torch.isinf(got)], want[torch.isinf(want)])
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    ok = bool((err <= rtol * want[fin].abs()).all())
    max_err = float(err.max()) if err.numel() else 0.0
    log(f"  {name}: max_abs_err={max_err!r} rtol={rtol} "
        f"{'ok' if ok and nan_ok and inf_ok else 'MISMATCH'}")
    if not (ok and nan_ok and inf_ok):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version\n kernel {got}\n plain  {want}")
    return max_err


def q1_like_inputs(n, num_segments, live_slots, dtype, seed):
    """Values and group ids at a grouped sum's shape on the main path:
    ``live_slots`` slots carry rows, about 4% of rows are dead (value 0,
    id 0)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gids = torch.randint(0, live_slots, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    values = torch.rand(n, generator=gen, device="cuda",
                        dtype=torch.float64) * 1e5
    dead = torch.rand(n, generator=gen, device="cuda") < 0.04
    values = torch.where(dead, 0.0, values).to(dtype)
    gids = torch.where(dead, 0, gids)
    assert live_slots <= num_segments
    return values, gids


def phase_probe():
    from arrow_tpu_torch.kernels import _build
    from arrow_tpu_torch.kernels.probe import probe
    from arrow_tpu_torch.platform_check import (card_name_and_power_limit,
                                                self_check)
    log("== phase 1: probe")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, nvcc {_build.nvcc_version()}")
    card = card_name_and_power_limit()
    log(f"kernel build: {_build.build_all():.2f} s for "
        f"{[s.name for s in _build.sources()]}")
    for name, out in _build.BUILD_LOG.items():
        for line in out.strip().splitlines():
            if "registers" in line or "smem" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")
    before = probe.launches
    info = self_check()
    if info.get("probe") != "ok" or probe.launches != before + 1:
        raise AssertionError(f"self_check did not launch the probe: {info}")
    log(f"self_check: {json.dumps(info)}")
    return card


def phase_kernels(n):
    from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                     grouped_sum_plain)
    from arrow_tpu_torch.kernels.probe import probe, probe_plain
    log("== phase 2: kernels against their plain versions")
    errs = {}
    v, g = q1_like_inputs(n, Q1_SLOTS, 6, torch.float64, 1)
    errs["grouped_sum"] = check_close(
        f"grouped_sum f64 n={n} S={Q1_SLOTS}", grouped_sum(v, g, Q1_SLOTS),
        grouped_sum_plain(v, g, Q1_SLOTS), RTOL_F64)
    v, g = q1_like_inputs(n, 512, 512, torch.float64, 2)
    errs["grouped_sum_s512"] = check_close(
        f"grouped_sum f64 n={n} S=512", grouped_sum(v, g, 512),
        grouped_sum_plain(v, g, 512), RTOL_F64)
    del v, g
    v, g = q1_like_inputs(1 << 22, 16, 16, torch.float32, 3)
    errs["grouped_sum_f32"] = check_close(
        "grouped_sum f32 n=4194304 S=16", grouped_sum(v, g, 16),
        grouped_sum_plain(v.double(), g, 16), RTOL_F32)
    for s in (Q1_SLOTS, 512):
        v, g = q1_like_inputs(1 << 20, s, s, torch.float64, 4)
        v[1000], g[1000] = float("inf"), 3
        v[2000], g[2000] = float("nan"), 7
        got = grouped_sum(v, g, s)
        if not (torch.isinf(got[3]) and torch.isnan(got[7])):
            raise AssertionError(f"Inf/NaN did not propagate: {got[:8]}")
        check_close(f"grouped_sum f64 Inf/NaN S={s}", got,
                    grouped_sum_plain(v, g, s), RTOL_F64)
    x = torch.randn(8, 128, device="cuda")
    errs["probe"] = check_close("probe (8,128) f32", probe(x),
                                probe_plain(x), 0.0)
    torch.cuda.synchronize()
    return errs


def q1_oracle(batch, n):
    """Q1 with numpy bincounts over the downloaded source columns, in the
    plan's output order."""
    from arrow_tpu_torch.io.tpch_queries import DATE_1998_09_02

    def col(name):
        return batch.column(name).values[:n].cpu().numpy()

    rf_dict = batch.column("l_returnflag").dictionary
    ls_dict = batch.column("l_linestatus").dictionary
    keep = col("l_shipdate") <= DATE_1998_09_02
    key = (col("l_returnflag").astype(np.int64) * len(ls_dict)
           + col("l_linestatus"))[keep]
    size = len(rf_dict) * len(ls_dict)
    qty, price = col("l_quantity")[keep], col("l_extendedprice")[keep]
    disc, tax = col("l_discount")[keep], col("l_tax")[keep]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    count = np.bincount(key, minlength=size)

    def s(w):
        return np.bincount(key, weights=w, minlength=size)

    groups = sorted((rf_dict[k // len(ls_dict)], ls_dict[k % len(ls_dict)],
                     k) for k in np.nonzero(count)[0])
    ks = np.array([k for _, _, k in groups])
    c = count[ks]
    return {
        "l_returnflag": [g[0] for g in groups],
        "l_linestatus": [g[1] for g in groups],
        "sum_qty": s(qty)[ks], "sum_base_price": s(price)[ks],
        "sum_disc_price": s(disc_price)[ks], "sum_charge": s(charge)[ks],
        "avg_qty": s(qty)[ks] / c, "avg_price": s(price)[ks] / c,
        "avg_disc": s(disc)[ks] / c, "count_order": c.tolist(),
    }


def phase_main_path():
    from arrow_tpu_torch.acero import compile_chain
    from arrow_tpu_torch.device.column import download
    from arrow_tpu_torch.io.tpch_device import q1_device_batch
    from arrow_tpu_torch.io.tpch_queries import q1_chain_decls
    from arrow_tpu_torch.kernels.grouped_sum import grouped_sum
    from arrow_tpu_torch.kernels.probe import probe
    from arrow_tpu_torch.platform_check import self_check
    log(f"== phase 3: the main path, Q1 at SF{SF:g} on the card")
    grouped_sum.launches = 0
    probe.launches = 0
    self_check()
    batch, n = q1_device_batch(SF)
    q1 = compile_chain(q1_chain_decls())
    result = download(q1(batch))
    launches = {"grouped_sum": grouped_sum.launches,
                "probe": probe.launches}
    log(f"launches on the main path: {launches}")
    if launches != {"grouped_sum": 7, "probe": 1}:
        raise AssertionError(f"expected 7 grouped_sum and 1 probe launches, "
                             f"got {launches}")
    want = q1_oracle(batch, n)
    if list(result) != list(want):
        raise AssertionError(f"columns {list(result)} != {list(want)}")
    for name, w in want.items():
        got = result[name]
        if isinstance(w, np.ndarray):
            g = np.asarray(got, dtype=np.float64)
            if g.shape != w.shape or not np.all(np.isfinite(g)) or \
                    not np.allclose(g, w, rtol=RTOL_F64, atol=0.0):
                raise AssertionError(f"{name}: {got} != {w.tolist()}")
        elif got != w:
            raise AssertionError(f"{name}: {got} != {w}")
    log(f"Q1 result ({len(result['count_order'])} groups) matches the numpy "
        f"oracle: keys and counts exact, floats within rtol {RTOL_F64}")
    for i in range(len(result["count_order"])):
        log("  " + " ".join(f"{k}={result[k][i]}" for k in result))
    return batch, n, q1, launches


def phase_times(card, batch, n, q1, launches, errs):
    from arrow_tpu_torch.device.column import download
    from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                     grouped_sum_plain)
    from arrow_tpu_torch.kernels.probe import probe, probe_plain
    log(f"== phase 4: times on {card}")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        download(q1(batch))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    best = min(walls[1:])
    log(f"Q1 SF{SF:g}: {n} rows, wall {[round(w * 1e3, 3) for w in walls]}"
        f" ms; best {best * 1e3:.3f} ms = {n / best:.6g} rows/s [{card}]")
    q1_profile(q1, batch)

    def record(name, values, gids, s, library_fn):
        n_rows = values.numel()
        nbytes = n_rows * (values.element_size() + 4) + s * \
            values.element_size()
        # one f64 addition a row, f32 input included
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_rows / F64_OPS_PER_S
        out = {
            "ms": cuda_ms(lambda: grouped_sum(values, gids, s)),
            "plain_ms": cuda_ms(lambda: grouped_sum_plain(values, gids, s)),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(library_fn),
        }
        log(f"  {name}: n={n_rows} S={s} kernel {out['ms']:.4f} ms, bound "
            f"{out['bound_ms']:.4f} ms ({out['bound_by']}), plain "
            f"{out['plain_ms']:.4f} ms, index_add_ {out['library_ms']:.4f} "
            f"ms, {nbytes / out['ms'] / 1e6:.1f} GB/s [{card}]")
        return out

    def index_add(values, gids, s):
        acc = torch.zeros(s, dtype=values.dtype, device="cuda")
        return lambda: acc.index_add_(0, gids, values)

    n_cap = batch.capacity
    v, g = q1_like_inputs(n_cap, Q1_SLOTS, 6, torch.float64, 1)
    q1_shape = record("grouped_sum f64 (Q1 shape)", v, g, Q1_SLOTS,
                      index_add(v, g, Q1_SLOTS))
    v, g = q1_like_inputs(n_cap, 512, 512, torch.float64, 2)
    record("grouped_sum f64 (K3 range)", v, g, 512, index_add(v, g, 512))
    v, g = q1_like_inputs(n_cap, 16, 16, torch.float32, 3)
    record("grouped_sum f32", v, g, 16, index_add(v, g, 16))
    del v, g

    x = torch.randn(8, 128, device="cuda")
    probe_rec = {"ms": cuda_ms(lambda: probe(x), reps=200),
                 "plain_ms": cuda_ms(lambda: probe_plain(x), reps=200),
                 "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes",
                 "library_ms": cuda_ms(lambda: torch.mul(x, 2.0), reps=200)}
    log(f"  probe: kernel {probe_rec['ms']:.4f} ms, plain "
        f"{probe_rec['plain_ms']:.4f} ms, torch.mul "
        f"{probe_rec['library_ms']:.4f} ms [{card}]")
    return {"kernels": [
        {"name": "grouped_sum", "route": "cuda",
         "source": "arrow_tpu_torch/csrc/grouped_sum.cu",
         "replaces": "arrow_tpu/experimental/pallas_agg.py:234",
         "launches": launches["grouped_sum"],
         "max_abs_err": errs["grouped_sum"], **q1_shape},
        {"name": "probe", "route": "cuda",
         "source": "arrow_tpu_torch/csrc/probe.cu",
         "replaces": "arrow_tpu/platform_check.py:119",
         "launches": launches["probe"], "max_abs_err": errs["probe"],
         **probe_rec},
    ]}


def q1_profile(q1, batch):
    """Device time of one Q1 run by operation, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from arrow_tpu_torch.device.column import download
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        download(q1(batch))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: an operator's device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    if not rows:
        log("Q1 profile: the profiler saw no device time (not measured)")
        return
    log(f"Q1 profile: device busy {device_us:.1f} us of {wall_us:.1f} us "
        f"wall (idle share {1 - device_us / wall_us:.3f}; profiler on)")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {us:12.1f} us  x{count:<4d} {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import arrow_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    try:
        card = phase_probe()
        from arrow_tpu_torch.device.column import round_up
        errs = phase_kernels(round_up(int(6_001_215 * SF)))
        batch, n, q1, launches = phase_main_path()
        kernels = phase_times(card, batch, n, q1, launches, errs)
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        return 1
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
