"""Where the kernels' time goes: K5 (csrc/flash_attention.cu), K10
(csrc/xent.cu) and K9 (csrc/moe_gemm.cu) in bf16, and K6
(csrc/decode_attention.cu), built beside variants with one part removed,
each timed at the main path's shapes on one card.

    PYTHONPATH=src python -m repro_torch.kernels.ablate [--baseline DIR]
        [source ...]

(sources: flash_attention, xent, moe_gemm, decode_attention; all by
default).  With --baseline, the same sources of another checkout rooted
at DIR (a `git archive` of an earlier commit, say) are built and timed
beside them as the variant "baseline", so two versions are compared
within one call; K9 is then also timed in fp32, both versions.

A variant computes a wrong result by design: it is timed, never checked.
The gap between a variant and the unchanged kernel is what that part costs
where it does not overlap the rest.  Every variant is a text substitution
of the current source; `variant_sources` raises if one no longer applies
(tests/test_torch_kernels.py checks that on the CPU), so the table stays
in step with the kernels.  Builds go to build/kernels/ablate/; nothing
here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import _build

Edit = Tuple[str, str]

#: source -> variant name -> substitutions (each must match exactly once)
VARIANTS: Dict[str, Dict[str, List[Edit]]] = {
    "flash_attention": {
        "no lo products": [
            ("      mma::mma_bf16(acc[2 * dp], pl, r[dp][0], r[dp][1]);\n"
             "      mma::mma_bf16(acc[2 * dp + 1], pl, r[dp][2], r[dp][3]);\n",
             "")],
        "no P V": [
            ("  for (int kk = 0; kk < KT / 16; ++kk) {\n    uint32_t ph[4]",
             "  for (int kk = 0; kk < 0; ++kk) {\n    uint32_t ph[4]")],
        "no exp2": [
            ("s[j][e] = ex2(fmaf(s[j][e], fold, -m_new));",
             "s[j][e] = fmaf(s[j][e], fold, -m_new);")],
        "no Q K^T products": [
            ("      mma::mma_bf16(s[2 * np], qf[kd], r[np][0], r[np][1]);\n"
             "      mma::mma_bf16(s[2 * np + 1], qf[kd], r[np][2], "
             "r[np][3]);\n",
             "      s[2 * np][0] += __uint_as_float(r[np][0]);\n")],
        "no K/V loads after the first": [
            ("      load_kv(it + KV_STAGES - 1);\n", "      ;\n")],
        "loads only": [
            ("      tile_step<D>(cK, cV, qf, m, l, acc, k0, row0, Sk, causal, "
             "scale2, lane);",
             "      acc[0][0] += __bfloat162float(cK[lane]) + "
             "__bfloat162float(cV[lane]);")],
    },
    "xent": {
        "no epilogue": [
            ("    const int c0 = v0 + wn * 64 + 2 * t4;\n"
             "    const bool full = v0 + MV <= v_end;",
             "#pragma unroll\n    for (int a = 0; a < 4; ++a)\n"
             "#pragma unroll\n      for (int b = 0; b < 8; ++b)\n"
             "#pragma unroll\n"
             "        for (int e = 0; e < 4; ++e) s[0] += acc[a][b][e];\n"
             "    const int c0 = v0 + wn * 64 + 2 * t4;\n"
             "    const bool full = false;\n    if (false)"),
            ("#pragma unroll\n    for (int i = 0; i < 8; ++i) {\n"
             "      const int mt = i >> 1, hh = i & 1;\n"
             "      float tmax",
             "    for (int i = 0; i < 8; ++i) {\n"
             "      const int mt = i >> 1, hh = i & 1;\n"
             "      float tmax")],
        "no products": [
            ("          mma::mma_bf16(acc[mt][2 * np], af[mt], bf[np][0], "
             "bf[np][1]);\n"
             "          mma::mma_bf16(acc[mt][2 * np + 1], af[mt], bf[np][2], "
             "bf[np][3]);\n",
             "          acc[mt][2 * np][0] += "
             "__uint_as_float(af[mt][0] ^ bf[np][0]);\n")],
        "no loads after the ring's first": [
            ("    if (it + STAGES - 1 < total) load_stage(it + STAGES - 1);\n",
             "")],
    },
    "moe_gemm": {                       # both bf16 kernels, prefill and tick
        "no products": [
            ("          mma::mma_bf16(acc[mt][2 * np], af[mt], bfr[np][0], "
             "bfr[np][1]);\n"
             "          mma::mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[np][2], "
             "bfr[np][3]);\n",
             "          acc[mt][2 * np][0] += "
             "__uint_as_float(af[mt][0] ^ bfr[np][0]);\n"),
            ("      mma::mma_bf16(acc, wf[0], xf[0], xf[1]);\n"
             "      mma::mma_bf16(acc, wf[1], xf[2], xf[3]);\n",
             "      acc[0] += "
             "__uint_as_float(wf[0][0] ^ wf[1][0] ^ xf[0]);\n")],
        "no loads after the ring's first": [
            ("    if (ks + STAGES - 1 < ksteps) "
             "load_stage(ks + STAGES - 1);\n", ""),
            ("    if (ks + STAGES - 1 < ksteps) fetch(ks + STAGES - 1);\n",
             "")],
        "loads only": [
            ("    for (int kk = 0; kk < PK / 16; ++kk) {",
             "    acc[0][0][0] += __bfloat162float(ca[lane]) + "
             "__bfloat162float(cb[lane]);\n"
             "    for (int kk = 0; kk < 0; ++kk) {"),
            ("    for (int kp = 0; kp < TK / 32; ++kp) {",
             "    acc[0] += __bfloat162float(cw[lane]) + "
             "__bfloat162float(cx[lane]);\n"
             "    for (int kp = 0; kp < 0; ++kp) {")],
    },
    "decode_attention": {
        "no score FMAs": [
            ("          dot[kk][0] = fmaf(qa.x, kf[0], dot[kk][0]);\n"
             "          dot[kk][1] = fmaf(qa.y, kf[1], dot[kk][1]);\n"
             "          dot[kk][0] = fmaf(qa.z, kf[2], dot[kk][0]);\n"
             "          dot[kk][1] = fmaf(qa.w, kf[3], dot[kk][1]);\n"
             "          dot[kk][0] = fmaf(qc.x, kf[4], dot[kk][0]);\n"
             "          dot[kk][1] = fmaf(qc.y, kf[5], dot[kk][1]);\n"
             "          dot[kk][0] = fmaf(qc.z, kf[6], dot[kk][0]);\n"
             "          dot[kk][1] = fmaf(qc.w, kf[7], dot[kk][1]);\n",
             "          dot[kk][0] += kf[0] + qa.x;\n"
             "          dot[kk][1] += kf[7] + qc.w;\n")],
        "no loads after the first": [
            ("    if (it + ST - 1 < n_tiles) load(it + ST - 1);\n", "")],
        "loads only": [
            ("    for (int gi = warp; gi < g; gi += kWarps) {",
             "    if (lane == 0) ps[warp] += to_f(kt[tid]) + to_f(vt[tid]);\n"
             "    for (int gi = warp; gi < 0; gi += kWarps) {"),
            ("      for (int j = group; j < nk; j += p.groups) {",
             "      for (int j = group; j < 0; j += p.groups) {")],
    },
}


def variant_sources(names=None, baseline=None) -> Dict[Tuple[str, str], str]:
    """(source, variant) -> the variant's text, "unchanged" included, for
    the sources in `names` (all by default), and "baseline" from the
    checkout rooted at `baseline` if given; raises if a substitution does
    not match its source exactly once."""
    out = {}
    for name, variants in VARIANTS.items():
        if names is not None and name not in names:
            continue
        src = (_build.CSRC / f"{name}.cu").read_text()
        out[(name, "unchanged")] = src
        if baseline is not None:
            out[(name, "baseline")] = (Path(baseline) / "src" / "repro_torch"
                                       / "csrc" / f"{name}.cu").read_text()
        for label, edits in variants.items():
            text = src
            for old, new in edits:
                if text.count(old) != 1:
                    raise ValueError(f"ablation {name} / {label}: a pattern "
                                     f"matches {text.count(old)} times")
                text = text.replace(old, new)
            out[(name, label)] = text
    return out


def _build_all(sources):
    """Compile every variant in parallel; returns the loaded libraries."""
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, out_dir)
    procs = {}
    for i, (key, text) in enumerate(sources.items()):
        cu = out_dir / f"v{i}_{key[0]}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[key] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation build {key} failed:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def _event_ms(torch, fn, reps):
    """Mean ms per call by CUDA events around `reps` calls queued behind a
    sleep kernel (as chip_smoke.py's `cuda_ms`)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1 << 26)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _variants(libs, name, fn_name, argtypes):
    """(label, C function) of every built variant of one source."""
    for (src, label), lib in libs.items():
        if src == name:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            yield label, fn


def _time_k5(torch, libs, rnd, dev, stream):
    rows = []
    for b, s in ((4, 2048), (1, 916)):      # the loss's call, a prefill
        q, k, v = rnd(b, 32, s, 64), rnd(b, 4, s, 64), rnd(b, 4, s, 64)
        o = torch.empty_like(q)
        lse = torch.empty((b, 32, s), device=dev)
        for label, fn in _variants(libs, "flash_attention",
                                   "flash_attention_fwd_bf16",
                                   [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                   + [ctypes.c_float, ctypes.c_void_p]):
            def call(fn=fn):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), b, 32, 4, s, s, 64,
                          1, 0.125, stream)
            if call():
                raise RuntimeError(f"K5 {label}: launch failed")
            rows.append(("K5", f"({b},32,{s},64) causal", label,
                         _event_ms(torch, call, 20)))
    return rows


def _time_k10(torch, libs, rnd, gen, dev, stream):
    rows = []
    t, d, vocab, chunk = 8192, 2048, 32000, 8192   # the loss's K10 call
    x, w = rnd(t, d), rnd(d, vocab, std=d ** -0.5)
    lab = torch.randint(0, vocab, (t,), generator=gen, device=dev,
                        dtype=torch.int32)
    nll = torch.empty(t, device=dev)
    amax = torch.empty(t, dtype=torch.int32, device=dev)
    part = torch.empty((5, -(-vocab // chunk), t), device=dev)
    counter = torch.zeros(-(-t // 128), dtype=torch.int32, device=dev)
    for label, fn in _variants(libs, "xent", "blocked_xent_bf16",
                               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p]):
        def call(fn=fn):
            counter.zero_()
            return fn(x.data_ptr(), w.data_ptr(), lab.data_ptr(),
                      nll.data_ptr(), amax.data_ptr(), part.data_ptr(),
                      counter.data_ptr(), t, vocab, d, chunk, 1, 1, stream)
        if call():
            raise RuntimeError(f"K10 {label}: launch failed")
        rows.append(("K10", f"x ({t},{d}) head ({d},{vocab})", label,
                     _event_ms(torch, call, 5)))
    return rows


def packed_ids(copies, block_m, experts, seed):
    """Block ids of the packed layout (models/moe.py::pack) for `copies`
    token copies routed uniformly at random: each expert's copies in
    whole blocks, in expert order, then -1 up to ceil(copies / block_m)
    + experts blocks."""
    import numpy as np
    counts = np.random.default_rng(seed).multinomial(
        copies, [1.0 / experts] * experts)
    ids = [e for e, c in enumerate(counts) for _ in range(-(-c // block_m))]
    return ids + [-1] * (-(-copies // block_m) + experts - len(ids))


def _time_k9(torch, libs, rnd, dev, stream):
    """DeepSeek-V2-Lite's routed gate product (d 2048 -> f 1408, 64
    experts, top-6) at a 916-token prefill (blocks of 64) and at a 4-slot
    decode tick (blocks of 8)."""
    rows = []
    w = rnd(64, 2048, 1408, std=2048 ** -0.5)
    for what, copies, bm, tile in (("prefill", 916 * 6, 64, 64),
                                   ("tick", 4 * 6, 8, 8)):
        ids = torch.tensor(packed_ids(copies, bm, 64, 0), dtype=torch.int32,
                           device=dev)
        t = ids.numel() * bm
        x = rnd(t, 2048)
        out = torch.empty((t, 1408), dtype=torch.bfloat16, device=dev)
        named = int((ids >= 0).sum())
        x32, w32, out32 = x.float(), w.float(), out.float()
        for dtype, fname, xx, ww, oo in (
                ("bf16", "grouped_gemm_bf16", x, w, out),
                ("fp32", "grouped_gemm_f32", x32, w32, out32)):
            for label, fn in _variants(libs, "moe_gemm", fname,
                                       [ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p]):
                if dtype == "fp32" and label not in ("unchanged",
                                                     "baseline"):
                    continue

                def call(fn=fn, xx=xx, ww=ww, oo=oo):
                    return fn(xx.data_ptr(), ww.data_ptr(), ids.data_ptr(),
                              oo.data_ptr(), t, bm, 64, 2048, 1408, tile, 1,
                              stream)
                if call():
                    raise RuntimeError(f"K9 {dtype} {label}: launch failed")
                rows.append(("K9", f"{what} gate {dtype} x ({t},2048), "
                             f"{named} of {ids.numel()} blocks of {bm}",
                             label, _event_ms(torch, call, 20)))
        del x32, w32, out32
    return rows


def _time_k6(torch, libs, rnd, dev, stream):
    """bf16 decode over a 32k cache of Qwen2.5-14B's heads (40 / 8 KV,
    D 128) and TinyLlama-1.1B's (4, 2048, 4, 64) cache, every key valid."""
    from repro_torch.kernels import decode_attention as da
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, h, hkv, sk, d in ((1, 40, 8, 32768, 128), (4, 32, 4, 2048, 64)):
        q, k, v = rnd(b, h, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
        o = torch.empty_like(q)
        for label, fn in _variants(libs, "decode_attention",
                                   "decode_attention_bf16",
                                   [ctypes.c_void_p] * 4 + [ctypes.c_int]
                                   + [ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 7
                                   + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p]):
            # the baseline with the cut its wrapper took: the reference's
            # nsplit 8 of whole 256-key tiles
            ns, per = ((8, -(-sk // 8 // 256) * 256) if label == "baseline"
                       else da.split_plan(b, hkv, sk, sms))
            acc = torch.empty((b, hkv, ns, h // hkv, d), device=dev)
            ml = torch.empty((2, b, hkv, ns, h // hkv), device=dev)

            def call(fn=fn, ns=ns, per=per, acc=acc, ml=ml):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, sk,
                          acc.data_ptr(), ml.data_ptr(), o.data_ptr(), b, h,
                          hkv, sk, d, ns, per, 1.0 / math.sqrt(d), 1, stream)
            if call():
                raise RuntimeError(f"K6 {label}: launch failed")
            rows.append(("K6", f"q ({b},{h},{d}) cache ({b},{sk},{hkv},{d}),"
                         f" {b * hkv * ns} CTAs", label,
                         _event_ms(torch, call, 20)))
    return rows


def main(argv=None) -> int:
    import torch
    args = list(argv if argv is not None else sys.argv[1:])
    baseline = None
    if "--baseline" in args:
        i = args.index("--baseline")
        baseline = args[i + 1]
        del args[i:i + 2]
    names = args or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"ablate: unknown sources {sorted(unknown)}; choose from "
              f"{list(VARIANTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = _build_all(variant_sources(names, baseline))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std
                ).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    timers = {"flash_attention": lambda: _time_k5(torch, libs, rnd, dev,
                                                  stream),
              "xent": lambda: _time_k10(torch, libs, rnd, gen, dev, stream),
              "moe_gemm": lambda: _time_k9(torch, libs, rnd, dev, stream),
              "decode_attention": lambda: _time_k6(torch, libs, rnd, dev,
                                                   stream)}
    rows = [row for name in names for row in timers[name]()]
    for kernel, shape, label, ms in rows:
        print(f"{kernel} {shape} {label}: {ms:.4f} ms", flush=True)
    print(json.dumps({"ablation": [dict(kernel=k, shape=s, variant=lbl,
                                        ms=ms) for k, s, lbl, ms in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
