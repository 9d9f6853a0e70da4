"""Where the bf16 kernels' time goes: K5 (csrc/flash_attention.cu) and K10
(csrc/xent.cu) built beside variants with one part removed, each timed at
the main path's shapes on one card.

    PYTHONPATH=src python -m repro_torch.kernels.ablate

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
import shutil
import subprocess
import sys
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
}


def variant_sources() -> Dict[Tuple[str, str], str]:
    """(source, variant) -> the variant's text, "unchanged" included;
    raises if a substitution does not match its source exactly once."""
    out = {}
    for name, variants in VARIANTS.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        out[(name, "unchanged")] = src
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = _build_all(variant_sources())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std
                ).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for b, s in ((4, 2048), (1, 916)):      # the loss's call, a prefill
        q, k, v = rnd(b, 32, s, 64), rnd(b, 4, s, 64), rnd(b, 4, s, 64)
        o = torch.empty_like(q)
        lse = torch.empty((b, 32, s), device=dev)
        for (name, label), lib in libs.items():
            if name != "flash_attention":
                continue
            fn = lib.flash_attention_fwd_bf16
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
                [ctypes.c_float, ctypes.c_void_p]

            def call(fn=fn):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), b, 32, 4, s, s, 64,
                          1, 0.125, stream)
            if call():
                raise RuntimeError(f"K5 {label}: launch failed")
            rows.append(("K5", f"({b},32,{s},64) causal", label,
                         _event_ms(torch, call, 20)))
    t, d, vocab, chunk = 8192, 2048, 32000, 8192   # the loss's K10 call
    x, w = rnd(t, d), rnd(d, vocab, std=d ** -0.5)
    lab = torch.randint(0, vocab, (t,), generator=gen, device=dev,
                        dtype=torch.int32)
    nll = torch.empty(t, device=dev)
    amax = torch.empty(t, dtype=torch.int32, device=dev)
    part = torch.empty((5, -(-vocab // chunk), t), device=dev)
    counter = torch.zeros(-(-t // 128), dtype=torch.int32, device=dev)
    for (name, label), lib in libs.items():
        if name != "xent":
            continue
        fn = lib.blocked_xent_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]

        def call(fn=fn):
            counter.zero_()
            return fn(x.data_ptr(), w.data_ptr(), lab.data_ptr(),
                      nll.data_ptr(), amax.data_ptr(), part.data_ptr(),
                      counter.data_ptr(), t, vocab, d, chunk, 1, 1, stream)
        if call():
            raise RuntimeError(f"K10 {label}: launch failed")
        rows.append(("K10", f"x ({t},{d}) head ({d},{vocab})", label,
                     _event_ms(torch, call, 5)))
    for kernel, shape, label, ms in rows:
        print(f"{kernel} {shape} {label}: {ms:.4f} ms", flush=True)
    print(json.dumps({"ablation": [dict(kernel=k, shape=s, variant=lbl,
                                        ms=ms) for k, s, lbl, ms in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
