#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Builds the port's kernels from ``spark_rapids_jni_tpu_torch/csrc`` and drives
the main path, fixed-width JCUDF row conversion, at the reference
benchmark's axes: 212 fixed-width columns (``cycle_dtypes`` of INT64,
FLOAT64, INT32, FLOAT32, INT16, INT8, BOOL8), 1M and 4M rows, both
directions, and then once at 10.24M rows of random planes, where the
kernels' element indices pass 2^31.  Every kernel is held against its plain
PyTorch version on the card, byte for byte, at every one of those shapes,
and every round trip must give back its input bit for bit, nulls and data
under nulls included.  Each kernel is timed at 1M rows; its bound is the
bytes it must move over the card's published memory rate.

Each phase prints one JSON line.  Near the end come the card's name and
power limit (``nvidia-smi``) and one ``{"kernels": [...]}`` line; the last
line is ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and does not print that line, as it does when no CUDA
card is present or the package is not beside it.  It needs no arguments,
one card and no network.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM device memory rate (NVIDIA data sheet): the bytes side of bound_ms
PEAK_BYTES_PER_S = 3.35e12
N_1M = 1_000_000
N_4M = 4_000_000
# rows of the 64-bit offsets phase: 213 planes of this many words pass 2^31
N_WIDE = 10_240_000
TIMED_RUNS = 15


def emit(**fields):
    print(json.dumps(fields), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, runs=TIMED_RUNS, warmup=3):
    """Median over ``runs`` of one call's device time, each call bracketed
    by its own CUDA events (inputs are far larger than the 50 MB L2, so
    every call reads them cold)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def copy_ms(nbytes: int) -> float:
    """Device-to-device copy moving ``nbytes`` in all (half read, half
    written): the card's own bandwidth anchor at the kernel's byte count."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return median_ms(lambda: dst.copy_(src))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors, taken over
    slices of 2^26 elements so that a 10 GB blob needs no full-size
    widened copy."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shapes {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    a, b = a.reshape(-1), b.reshape(-1)
    worst = 0
    for i in range(0, a.numel(), 1 << 26):
        x = a[i:i + (1 << 26)].to(torch.int64)
        y = b[i:i + (1 << 26)].to(torch.int64)
        worst = max(worst, int((x - y).abs().max()))
    return worst


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs a CUDA card")
    from spark_rapids_jni_tpu_torch import (
        BOOL8, FLOAT32, FLOAT64, INT8, INT16, INT32, INT64, UINT8, UINT16,
        UINT32, UINT64, decimal32, decimal64,
    )
    from spark_rapids_jni_tpu_torch.ops import (
        compute_row_layout, convert_from_rows, convert_from_rows_grouped,
        convert_to_rows, convert_to_rows_fixed_width_optimized,
        convert_to_rows_grouped,
    )
    from spark_rapids_jni_tpu_torch.ops import kernels, row_mxu
    from spark_rapids_jni_tpu_torch.table import (
        assert_tables_equivalent, slice_table,
    )
    from spark_rapids_jni_tpu_torch.utils import cycle_dtypes, random_table

    smi = nvidia_smi_line()
    emit(phase="device", nvidia_smi=smi,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    t0 = time.perf_counter()
    kernels.build_kernels()
    ptxas = {name: [ln.strip() for ln in kernels.build_log(name).splitlines()
                    if "Used" in ln or "spill" in ln]
             for name in kernels.SOURCES}
    emit(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    dtypes = cycle_dtypes([INT64, FLOAT64, INT32, FLOAT32, INT16, INT8,
                           BOOL8], 212)
    layout = compute_row_layout(dtypes)
    rs = layout.fixed_row_size
    wd = row_mxu._data_words(layout)
    w = row_mxu._inverse_plan(layout)[0].num_words
    check((rs, wd, w) == (1008, 214, 221), f"layout {(rs, wd, w)}")
    errs = {"grouped_encode": 0, "decode_planes": 0}

    # -- the main path, 1M rows: encode then decode, counts read around it
    table = random_table(dtypes, N_1M, seed=0, null_probability=0.25)
    torch.cuda.synchronize()
    kernels.reset_launches()
    batches = convert_to_rows(table)
    decoded = convert_from_rows(batches[0], dtypes)
    torch.cuda.synchronize()
    main_launches = dict(kernels.launches)
    check(all(v > 0 for v in main_launches.values()),
          f"a kernel of the main path never launched: {main_launches}")

    blob = batches[0].data
    check(len(batches) == 1 and tuple(blob.shape) == (N_1M, rs),
          f"encode gave {[tuple(b.data.shape) for b in batches]}")
    gc = row_mxu.table_to_grouped(table, layout)
    plain = kernels.grouped_encode_plain(gc.planes, gc.vmask, layout, 0, N_1M)
    errs["grouped_encode"] = max(errs["grouped_encode"],
                                 max_abs_err(blob, plain))
    check(torch.equal(blob, plain), "encode kernel != plain version")
    del plain
    oracle = convert_to_rows_fixed_width_optimized(table)[0].data
    check(torch.equal(blob, oracle), "encode kernel != gather oracle")
    del oracle
    emit(phase="encode_1m", rows=N_1M, row_size=rs, batches=len(batches),
         launches=main_launches["grouped_encode"], equal_plain=True,
         equal_oracle=True)

    planes_k, vmask_k = kernels.decode_planes(blob, layout)
    planes_p, vmask_p = kernels.decode_planes_plain(blob, layout)
    errs["decode_planes"] = max(max_abs_err(planes_k, planes_p),
                                max_abs_err(vmask_k, vmask_p))
    check(torch.equal(planes_k, planes_p) and torch.equal(vmask_k, vmask_p),
          "decode kernel != plain version")
    check(torch.equal(vmask_k, gc.vmask), "decoded masks != input masks")
    del planes_p, vmask_p
    assert_tables_equivalent(table, decoded, check_nulls=False)
    emit(phase="decode_1m", rows=N_1M,
         launches=main_launches["decode_planes"], equal_plain=True,
         roundtrip_bit_exact=True)

    # -- grouped forms: decode to the backing, encode straight back
    g = convert_from_rows_grouped(batches[0], dtypes)
    check(torch.equal(g.planes[:wd], gc.planes), "grouped planes != pack")
    again = convert_to_rows_grouped(g)
    check(len(again) == 1 and torch.equal(again[0].data, blob),
          "grouped round trip changed the rows")
    emit(phase="grouped_1m", rows=N_1M, bytes_identical=True)
    del g, again, decoded, planes_k, vmask_k

    # -- timing at 1M rows (kernel, plain version, copy anchor)
    enc_bytes = 4 * wd * N_1M + gc.vmask.numel() + N_1M * rs
    dec_bytes = N_1M * rs + 4 * w * N_1M + gc.vmask.numel()
    timing = {}
    for name, fn, plain_fn, nbytes in (
            ("grouped_encode",
             lambda: kernels.grouped_encode(gc.planes, gc.vmask, layout, 0,
                                            N_1M),
             lambda: kernels.grouped_encode_plain(gc.planes, gc.vmask,
                                                  layout, 0, N_1M),
             enc_bytes),
            ("decode_planes",
             lambda: kernels.decode_planes(blob, layout),
             lambda: kernels.decode_planes_plain(blob, layout),
             dec_bytes)):
        timing[name] = {
            "ms": median_ms(fn), "plain_ms": median_ms(plain_fn, runs=10),
            "copy_ms": copy_ms(nbytes), "bytes": nbytes,
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
    # the entry points around the kernels: the pack into the backing, and
    # the per-column extraction after the decode
    end_to_end = {
        "table_to_grouped_ms": median_ms(
            lambda: row_mxu.table_to_grouped(table, layout), runs=10),
        "convert_to_rows_ms": median_ms(lambda: convert_to_rows(table),
                                        runs=10),
        "convert_from_rows_ms": median_ms(
            lambda: convert_from_rows(batches[0], dtypes), runs=10)}
    emit(phase="timing", rows=N_1M, runs=TIMED_RUNS, **timing, **end_to_end)
    del table, batches, blob, gc

    # -- 4M rows: two batches under the grouped policy, each kernel against
    # its plain version at the batch's start and size, round trip exact
    table = random_table(dtypes, N_4M, seed=1, null_probability=0.25)
    batches = convert_to_rows(table)
    sizes = [b.num_rows for b in batches]
    check(sizes == [2_000_896, 1_999_104], f"4M batches {sizes}")
    check(all(b.data.numel() <= (1 << 31) - 1 for b in batches),
          "a batch exceeds 2^31 - 1 bytes")
    gc = row_mxu.table_to_grouped(table, layout)
    start = 0
    for b in batches:
        plain = kernels.grouped_encode_plain(gc.planes, gc.vmask, layout,
                                             start, b.num_rows)
        errs["grouped_encode"] = max(errs["grouped_encode"],
                                     max_abs_err(b.data, plain))
        check(torch.equal(b.data, plain), f"4M encode kernel != plain "
                                          f"version at start {start}")
        del plain
        pk, vk = kernels.decode_planes(b.data, layout)
        pp, vp = kernels.decode_planes_plain(b.data, layout)
        errs["decode_planes"] = max(errs["decode_planes"],
                                    max_abs_err(pk, pp), max_abs_err(vk, vp))
        check(torch.equal(pk, pp) and torch.equal(vk, vp),
              f"4M decode kernel != plain version at start {start}")
        vbytes0 = start // 8
        check(torch.equal(vk, gc.vmask[:, vbytes0:vbytes0 + vk.shape[1]]),
              f"4M decoded masks != input masks at start {start}")
        del pk, vk, pp, vp
        part = convert_from_rows(b, dtypes)
        assert_tables_equivalent(slice_table(table, start, start + b.num_rows),
                                 part, check_nulls=False)
        start += b.num_rows
        del part
    emit(phase="multibatch_4m", rows=N_4M, batch_rows=sizes,
         batch_bytes=[b.data.numel() for b in batches], equal_plain=True,
         roundtrip_bit_exact=True)
    del table, batches, gc, b
    torch.cuda.empty_cache()

    # -- 64-bit offsets: random planes of N_WIDE rows, so that the index of
    # the last data plane's words (read by the encode) and of the last
    # decoded plane's words (written by the decode) pass 2^31 elements, and
    # the blob passes 2^31 bytes; each kernel against its plain version
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    planes = torch.randint(0, 256, (wd, 4 * N_WIDE), dtype=torch.uint8,
                           device="cuda", generator=gen).view(torch.int32)
    vmask = torch.randint(0, 256, (layout.num_columns, N_WIDE // 8),
                          dtype=torch.uint8, device="cuda", generator=gen)
    read_max = (wd - 1) * N_WIDE + N_WIDE - 1
    written_max = (w - 1) * N_WIDE + N_WIDE - 1
    check(min(read_max, written_max, N_WIDE * rs) > (1 << 31),
          "the wide phase does not pass 2^31")
    rows_k = kernels.grouped_encode(planes, vmask, layout, 0, N_WIDE)
    plain = kernels.grouped_encode_plain(planes, vmask, layout, 0, N_WIDE)
    errs["grouped_encode"] = max(errs["grouped_encode"],
                                 max_abs_err(rows_k, plain))
    check(torch.equal(rows_k, plain), "wide encode kernel != plain version")
    del plain, planes
    pk, vk = kernels.decode_planes(rows_k, layout)
    pp, vp = kernels.decode_planes_plain(rows_k, layout)
    errs["decode_planes"] = max(errs["decode_planes"], max_abs_err(pk, pp),
                                max_abs_err(vk, vp))
    check(torch.equal(pk, pp) and torch.equal(vk, vp),
          "wide decode kernel != plain version")
    check(torch.equal(vk, vmask), "wide decoded masks != input masks")
    emit(phase="offsets_64bit", rows=N_WIDE, max_plane_index_read=read_max,
         max_plane_index_written=written_max, blob_bytes=N_WIDE * rs,
         equal_plain=True)
    del rows_k, pk, vk, pp, vp, vmask
    torch.cuda.empty_cache()

    # -- edges: every fixed type, odd sizes, all null patterns, odd starts
    # and a padded row stride, each kernel against its plain version
    all_fixed = [INT64, FLOAT64, UINT64, INT32, UINT32, FLOAT32, INT16,
                 UINT16, INT8, UINT8, BOOL8, decimal32(2), decimal64(-1)]
    elayout = compute_row_layout(all_fixed)
    cases = 0
    for n in (1, 31, 6 * 1024 + 557):
        for nulls in (None, 0.0, 1.0, 0.25):
            t = random_table(all_fixed, n, seed=n, null_probability=nulls)
            eg = row_mxu.table_to_grouped(t, elayout)
            for s in sorted({0, min(3, n - 1), n // 2}):
                k = kernels.grouped_encode(eg.planes, eg.vmask, elayout, s,
                                           n - s)
                p = kernels.grouped_encode_plain(eg.planes, eg.vmask,
                                                 elayout, s, n - s)
                errs["grouped_encode"] = max(errs["grouped_encode"],
                                             max_abs_err(k, p))
                check(torch.equal(k, p), f"encode n={n} nulls={nulls} "
                                         f"start={s}")
                cases += 1
            rows = kernels.grouped_encode(eg.planes, eg.vmask, elayout, 0, n)
            wide = torch.zeros((n, elayout.fixed_row_size + 24),
                               dtype=torch.uint8, device="cuda")
            wide[:, :elayout.fixed_row_size] = rows
            for r2d in (rows, wide):
                pk, vk = kernels.decode_planes(r2d, elayout)
                pp, vp = kernels.decode_planes_plain(r2d, elayout)
                errs["decode_planes"] = max(errs["decode_planes"],
                                            max_abs_err(pk, pp),
                                            max_abs_err(vk, vp))
                check(torch.equal(pk, pp) and torch.equal(vk, vp),
                      f"decode n={n} nulls={nulls} stride={r2d.shape[1]}")
                cases += 1
            back = row_mxu.GroupedColumns(pk, vk, elayout).to_table()
            assert_tables_equivalent(t, back, check_nulls=False)
    emit(phase="edges", cases=cases, max_abs_err=errs)

    kernel_lines = []
    for name, replaces in (
            ("grouped_encode", "spark_rapids_jni_tpu/ops/row_mxu.py:513"),
            ("decode_planes", "spark_rapids_jni_tpu/ops/row_mxu.py:954")):
        tm = timing[name]
        kernel_lines.append({
            "name": name, "route": "cuda",
            "source": ("spark_rapids_jni_tpu_torch/csrc/"
                       + kernels.SOURCES[name]),
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": errs[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    print(smi, flush=True)
    emit(kernels=kernel_lines)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
