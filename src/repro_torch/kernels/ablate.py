"""Where the kernels' time goes: K5 (csrc/flash_attention.cu), K11
(csrc/flash_attention_bwd.cu), K10 (csrc/xent.cu), K9 (csrc/moe_gemm.cu)
and its Hopper backward (`moe_gemm_bwd`: `gg_dx_sm90` and `gg_dw_sm90` of
the same source, at Moonlight-16B-A3B's train step) and K12a
(csrc/xent_bwd.cu: `xent_bwd_sm90` over a whole call's chunks at
TinyLlama-1.1B's and Moonlight-16B-A3B's heads) in bf16, K6
(csrc/decode_attention.cu), the chunk
kernels K2 (csrc/scan_chunk.cu) and K1 (csrc/coupled_chunk.cu) in fp64
and fp32, K7 (csrc/ssm_scan.cu), K8 (csrc/rmsnorm.cu) and K12c
(csrc/selective_scan.cu, at Falcon-Mamba-7B's prefills), built beside
variants with one part removed, each timed at the main path's shapes on
one card.

    PYTHONPATH=src python -m repro_torch.kernels.ablate [--baseline DIR]
        [--ids FILE] [source ...]

(sources: flash_attention, flash_attention_bwd, xent, xent_bwd,
moe_gemm, moe_gemm_bwd, decode_attention, scan_chunk, coupled_chunk,
ssm_scan, rmsnorm, selective_scan; all by default).  With
--baseline, the same sources of another checkout rooted at DIR (a `git
archive` of an earlier commit, say) are built and timed beside them as
the variant "baseline", so two versions are compared within one call;
K9 is then also timed in fp32, both versions, K9's backward of a
checkout without the sm90 kernels by its bf16 `mma.sync` kernels (K12a's
"mma" route is timed beside the unchanged kernel and the baseline), and
K2's and K1's variants are applied to the baseline too
(`BASELINE_VARIANTS`, "baseline: <variant>").  With --ids, K9's
backward takes its block ids and block_m from FILE, the .npz that
chip_smoke.py writes from a Moonlight step's routing
(chiprun_out/chip_smoke/moonlight_step_ids.npz), in place of uniformly
routed ids.

A variant computes a wrong result by design: it is timed, never checked.
The gap between a variant and the unchanged kernel is what that part costs
where it does not overlap the rest.  Variants named "alt: ..." are design
alternatives the kernel was chosen against; they compute the right
result (K7's and K12c's are checked against their plain versions and
the error is printed; a K12c "alt:" over K12c's bar of 1e-5 of max |y|
raises).  Every variant is a text substitution
of the current source, with its local headers (`*.cuh`) inlined;
`variant_sources` raises if one no longer applies
(tests/test_torch_kernels.py checks that on the CPU), so the table stays
in step with the kernels.  Builds go to build/kernels/ablate/; nothing
here runs when the package is imported.  Each variant's `ptxas -v`
registers and the blocks an SM holds at its launch width are printed
beside its time.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import _build

Edit = Tuple[str, str]

#: variant sets that edit another set's source file
SOURCE_FILE = {"moe_gemm_bwd": "moe_gemm"}

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
    "flash_attention_bwd": {            # K11's bf16 kernels, dq and dk/dv
        "no lo products": [
            ("      mma::mma_bf16(acc[2 * dn], dl, r[0], r[1]);\n"
             "      mma::mma_bf16(acc[2 * dn + 1], dl, r[2], r[3]);\n", ""),
            ("      mma::mma_bf16(adv[2 * dn], pl, rd[0], rd[1]);\n"
             "      mma::mma_bf16(adv[2 * dn + 1], pl, rd[2], rd[3]);\n"
             "      mma::mma_bf16(adk[2 * dn], dl, rq[0], rq[1]);\n"
             "      mma::mma_bf16(adk[2 * dn + 1], dl, rq[2], rq[3]);\n",
             "")],
        "no dQ product": [
            ("      mma::mma_bf16(acc[2 * dn], dh, r[0], r[1]);\n"
             "      mma::mma_bf16(acc[2 * dn + 1], dh, r[2], r[3]);\n"
             "      mma::mma_bf16(acc[2 * dn], dl, r[0], r[1]);\n"
             "      mma::mma_bf16(acc[2 * dn + 1], dl, r[2], r[3]);\n",
             "      acc[2 * dn][0] += __uint_as_float(dh[dn & 3] ^ dl[dn & 3]"
             " ^ r[0]);\n")],
        "no dK/dV products": [
            ("      mma::mma_bf16(adv[2 * dn], ph, rd[0], rd[1]);\n"
             "      mma::mma_bf16(adv[2 * dn + 1], ph, rd[2], rd[3]);\n"
             "      mma::mma_bf16(adk[2 * dn], dh, rq[0], rq[1]);\n"
             "      mma::mma_bf16(adk[2 * dn + 1], dh, rq[2], rq[3]);\n"
             "      mma::mma_bf16(adv[2 * dn], pl, rd[0], rd[1]);\n"
             "      mma::mma_bf16(adv[2 * dn + 1], pl, rd[2], rd[3]);\n"
             "      mma::mma_bf16(adk[2 * dn], dl, rq[0], rq[1]);\n"
             "      mma::mma_bf16(adk[2 * dn + 1], dl, rq[2], rq[3]);\n",
             "      adv[2 * dn][0] += __uint_as_float(ph[dn & 3] ^ pl[dn & 3]"
             " ^ rd[0]);\n"
             "      adk[2 * dn][0] += __uint_as_float(dh[dn & 3] ^ dl[dn & 3]"
             " ^ rq[0]);\n")],
        "no exp2": [
            ("float p = ex2(fmaf(s[j][e], scale2, -lse2[r]));",
             "float p = fmaf(s[j][e], scale2, -lse2[r]);"),
            ("float p = ex2(fmaf(s[j][e], scale2, -lq[e & 1]));",
             "float p = fmaf(s[j][e], scale2, -lq[e & 1]);")],
        "no loads after the rings' first": [
            ("    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);\n",
             ""),
            ("    if (i + STAGES - 1 < n_items) load_item(i + STAGES - 1);\n",
             "")],
        "alt: masks on every tile (no branch-free interior path)": [
            ("    if (k0 + BK > Sk || (causal && k0 + BK - 1 > row0))\n",
             "    if (true)\n"),
            ("    if (q0 + BQ > Sq || key0 + 16 > Sk || (causal && q0 < key0 + "
             "15))\n", "    if (true)\n")],
        "alt: dk/dv K, V from shared memory at D = 64": [
            ("constexpr int KV_REG_MAX_D = 64;",
             "constexpr int KV_REG_MAX_D = 32;")],
        "alt: dq dO fragments from shared memory at D = 64": [
            ("constexpr int DO_REG_MAX_D = 64;",
             "constexpr int DO_REG_MAX_D = 32;")],
        "alt: dq key steps unrolled": [
            ("#pragma unroll 1\n  for (int ks = 0; ks < BK / 16; ++ks) {",
             "#pragma unroll\n  for (int ks = 0; ks < BK / 16; ++ks) {")],
        "alt: dq 1 block an SM (no register cap)": [
            ("__launch_bounds__(HPC * 128, D <= 64 ? 4 / HPC : 1)",
             "__launch_bounds__(HPC * 128, D <= 32 ? 4 / HPC : 1)")],
        "alt: 3-stage rings": [
            ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
        "alt: dq one head a block": [
            ("const int hpc = mma_path && (H / Hkv) % 2 == 0 ? 2 : 1;",
             "const int hpc = 1;")],
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
    "moe_gemm_bwd": {                   # gg_dx_sm90 and gg_dw_sm90
        "no products (the TMA ring alone)": [
            ("        wg::mma<BN, TR, TR>(acc, da + kk * STEP, db + kk * STEP,\n"
             "                            kk > 0 || !(m.flags & FIRST));\n",
             "        acc[kk] += __uint_as_float((unsigned)(da ^ db));\n")],
        "no loads after the ring's first (the wgmmas alone)": [
            ("        wg::bar_arrive_expect_tx(&sm.full[s], span * BOX_BYTES + "
             "B_BYTES);\n",
             "        if (it >= STAGES) {\n"
             "          wg::bar_arrive(&sm.full[s]);\n"
             "          continue;\n"
             "        }\n"
             "        wg::bar_arrive_expect_tx(&sm.full[s], span * BOX_BYTES + "
             "B_BYTES);\n"),
            ("          wg::bar_arrive_expect_tx(&sm.full[s], STAGE_BYTES);\n",
             "          if (it >= STAGES) {\n"
             "            wg::bar_arrive(&sm.full[s]);\n"
             "            continue;\n"
             "          }\n"
             "          wg::bar_arrive_expect_tx(&sm.full[s], STAGE_BYTES);\n")],
        "no output stores (the staging into shared memory kept)": [
            ("        epi(m, buf);\n", "")],
        "alt: one consumer warpgroup (64-row tiles)": [
            ("constexpr int CONSUMERS = 2;", "constexpr int CONSUMERS = 1;")],
        "alt: 2-stage ring": [
            ("constexpr int STAGES = 3;          // depth of the TMA ring",
             "constexpr int STAGES = 2;          // depth of the TMA ring")],
        "alt: wait<1>, a stage released one step late": [
            ("  for (int it = 0;; ++it) {\n    const int s = it % STAGES;\n"
             "    wg::bar_wait(&sm.full[s], (it / STAGES) & 1);",
             "  int pending = -1;\n  for (int it = 0;; ++it) {\n"
             "    const int s = it % STAGES;\n"
             "    wg::bar_wait(&sm.full[s], (it / STAGES) & 1);"),
            ("      wg::commit();\n      wg::wait<0>();\n    }\n"
             "    if (signal) wg::bar_arrive(&sm.empty[s]);\n",
             "      wg::commit();\n"
             "      if (m.flags & LAST) wg::wait<0>(); else wg::wait<1>();\n"
             "      if (signal && pending >= 0) "
             "wg::bar_arrive(&sm.empty[pending]);\n"
             "      pending = m.flags & LAST ? -1 : s;\n"
             "      if (signal && (m.flags & LAST)) "
             "wg::bar_arrive(&sm.empty[s]);\n"
             "    } else if (signal) {\n"
             "      wg::bar_arrive(&sm.empty[s]);\n    }\n")],
        "alt: 128-wide N": [
            ("constexpr int BN = 256;", "constexpr int BN = 128;")],
    },
    "xent_bwd": {                       # K12a's sm90 kernel, xent_bwd_sm90
        "no products (the TMA ring alone)": [
            ("        wg::mma<BN, 0, EMB_DV>(acc, da + kk * 2, db + kk * B_STEP,\n"
             "                               kk > 0 || !(m.flags & FIRST));\n",
             "        acc[kk] += __uint_as_float((unsigned)(da ^ db));\n")],
        "no loads after the ring's first (the wgmmas alone)": [
            ("        wg::bar_arrive_expect_tx(&sm.full[s], STAGE_BYTES);\n",
             "        if (it >= STAGES) {\n"
             "          wg::bar_arrive(&sm.full[s]);\n"
             "          continue;\n"
             "        }\n"
             "        wg::bar_arrive_expect_tx(&sm.full[s], STAGE_BYTES);\n")],
        "no dl stores (dl formed and staged)": [
            ("    wg::tma_store_2d(map, buf + b * BOX_BYTES, col0 + 64 * b, "
             "row0);\n", "    ;\n")],
        "alt: 2-stage ring": [
            ("constexpr int STAGES = 3;          // depth of the TMA ring",
             "constexpr int STAGES = 2;          // depth of the TMA ring")],
        "alt: one consumer warpgroup (64-row tiles)": [
            ("constexpr int CONSUMERS = 2;       // consumer warpgroups, 64 "
             "token rows each",
             "constexpr int CONSUMERS = 1;       // consumer warpgroups, 64 "
             "token rows each")],
        "alt: column tiles under each token tile (the other raster)": [
            ("        const int r = i % rows;\n"
             "        const int c = i / rows;\n",
             "        const int r = i / cols;\n"
             "        const int c = i % cols;\n")],
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
    "scan_chunk": {
        "fast pow": [
            ("  if constexpr (CHAIN)\n"
             "    return (float)xpow((double)a, (double)b);\n"
             "  else\n    return powf(a, b);",
             "  return __powf(a, b);"),
            ("  return a > 0.0 ? pos : (a == 0.0 ? zero : a);",
             "  return (double)__powf((float)a, (float)b);")],
        "no series loads": [
            ("    stage<W>(st, rowidx, a0, 1, valid, nrows, C, t0, vec);\n"
             "    st += nrows * W * 4;\n"
             "    stage<W>(st, bg, a0, 1, valid, nrows, C, t0, vec);\n"
             "    stage<W>(st + arr, pr, a0, 1, valid, nrows, C, t0, vec);\n"
             "    stage<W>(st + 2 * arr, lens, a0, 1, valid, nrows, C, t0, "
             "vec);\n", ""),
            ("      stage<W>(st + (3 + e) * arr, cf, a0 * EC + e, EC, valid, "
             "nrows, C, t0,\n", "      if (0) (0,\n"),
            ("for (int j = 0; j < W; ++j) row[j] = at<int, W>(st, r, j);",
             "for (int j = 0; j < W; ++j) row[j] = (t0 + j) % R;"),
            ("carina::rates(u, bt, at<T, W>(st, r, j), p)",
             "carina::rates(u, bt, T(0.25), p)"),
            ("fmin((double)at<T, W>(st + 2 * arr, r, j),", "fmin(3600.0,"),
            ("en * (double)at<T, W>(st + (3 + e) * arr, r, j);", "en * 0.4;"),
            ("en * (double)at<T, W>(st + arr, r, j);", "en * 0.1;")],
        # design alternatives, measured beside the kernel
        "alt: 32-byte rows": [("constexpr int TS = 64 / (int)sizeof(T);",
                               "constexpr int TS = 32 / (int)sizeof(T);")],
        "alt: 128-byte rows": [("constexpr int TS = 64 / (int)sizeof(T);",
                                "constexpr int TS = 128 / (int)sizeof(T);")],
        "alt: 3 stages": [("constexpr int STAGES = 2;",
                           "constexpr int STAGES = 3;")],
        "alt: L2 128B prefetch": [("cp.async.cg.shared.global [%0]",
                                   "cp.async.cg.shared.global.L2::128B [%0]")],
        "loads only": [
            ("const Rates<T> rr = carina::rates(u, bt, at<T, W>(st, r, j), "
             "p);",
             "const Rates<T> rr = {T(1e-3) + T(1e-9) * u, "
             "at<T, W>(st, r, j) + bt, T(1e-12)};")],
    },
    "coupled_chunk": {
        "fast pow": [
            ("  if constexpr (CHAIN)\n"
             "    return (float)xpow((double)a, (double)b);\n"
             "  else\n    return powf(a, b);",
             "  return __powf(a, b);"),
            ("  return a > 0.0 ? pos : (a == 0.0 ? zero : a);",
             "  return (double)__powf((float)a, (float)b);")],
        "no series loads": [
            ("const size_t s = L * C + t;", "const size_t s = L * C;"),
            ("in.off = office[gg * C + t];", "in.off = office[gg * C];"),
            ("in.cf[e] = cf[(L * EC + e) * C + t];",
             "in.cf[e] = cf[(L * EC + e) * C];")],
        "loads only": [
            ("      const T pw = carina::power_w<T, true>(x, p.idle, p.dyn, "
             "p.alpha);", "      const T pw = x;"),
            ("      return carina::point(uu, bt, bgt, p, p_work, p_oh);",
             "      return Point<T>{T(1) + T(1e-9) * uu, p_work + p_oh + bt};"),
            ("    return carina::power_w<T, true>(bgt, p.idle, p.dyn, p.alpha);",
             "    return bgt;")],
        "one throttle step": [
            ("for (int it = 0; it < iters; ++it) {",
             "for (int it = 0; it < 1; ++it) {")],
        # design alternatives, measured beside the kernel
        "alt: butterfly of log2(Lp) levels": [
            ("#pragma unroll\n  for (int off = 16; off > 0; off >>= 1) {\n"
             "    const T x",
             "  for (int off = WARP ? Lp >> 1 : 16; off > 0; off >>= 1) {\n"
             "    const T x")],
        "alt: no shared power terms": [("32 / (gpw * Lp) >= 4", "false")],
        "alt: 32 / Lp groups a warp": [
            ("while (gpw < 32 / Lp && (long long)G > 8LL * sms * gpw) gpw *= 2;",
             "gpw = 32 / Lp;")],
    },
    "ssm_scan": {
        "no phase 1": [
            ("    chunk_aggregates<T><<<aggs, kThreads, 0, st>>>(a, b, agg, "
             "steps,\n"
             "                                                   channels, "
             "chunks, len);\n", "")],
        "no phase 2": [
            ("  for (int j = 0; j < k; ++j) h = carry(ag[(size_t)j * "
             "channels], h);\n", "")],
        "no hs stores": [
            ("    h = fmaf(to_f(a[off]), h, to_f(b[off]));\n"
             "    hs[off] = h;\n",
             "    h = fmaf(to_f(a[off]), h, to_f(b[off]));\n")],
        # the design alternative, measured beside the kernel
        "alt: one pass": [("constexpr bool kOnePass = false;",
                           "constexpr bool kOnePass = true;")],
    },
    "selective_scan": {
        "no exponentials": [("const float a = expf(__fmul_rn(dtv[u], an));",
                             "const float a = __fmul_rn(dtv[u], an);")],
        "no y sum": [
            ("      for (int off = G / 2; off > 0; off >>= 1)\n"
             "        s = __fadd_rn(s, __shfl_xor_sync(group, s, off, G));\n",
             "")],
        "no y stores": [("if (n == 0) yp[", "if (n == 0 && s == -1.f) yp[")],
        # every group of steps reads the first group's inputs (from L1)
        "no loads after the first group": [("const int t = t0 + u;",
                                             "const int t = u;")],
        # design alternatives, measured beside the kernel
        "alt: __expf": [("expf(__fmul_rn(dtv[u], an))",
                         "__expf(__fmul_rn(dtv[u], an))")],
        "alt: 4 blocks an SM": [("constexpr int kMinBlocks = 8;",
                                 "constexpr int kMinBlocks = 4;")],
        "alt: 8 steps loaded ahead": [("constexpr int kUnroll = 4;",
                                       "constexpr int kUnroll = 8;")],
    },
    "rmsnorm": {
        "no scale loads": [
            ("  for (int k = 0; k < K; ++k) sv[k] = __ldg(sr + tid + k * "
             "TPR);",
             "  for (int k = 0; k < K; ++k) sv[k] = make_uint4(0, 0, 0, 0);")],
        "no stores": [
            ("  for (int k = 0; k < K; ++k) yr[tid + k * TPR] = "
             "scaled<T>(xv[k], sv[k], r);",
             "  for (int k = 0; k < K; ++k)\n    if (r < 0.f) yr[tid + k * "
             "TPR] = scaled<T>(xv[k], sv[k], r);")],
        # design alternatives, measured beside the kernel
        "alt: 8 rows a block": [
            ("rmsnorm_rows<T, D, 32><<<grid, 32 * rpb, 0, st>>>",
             "rmsnorm_rows<T, D, 32><<<(rows + 7) / 8, 256, 0, st>>>")],
        "alt: scale loads after the sum": [
            ("#pragma unroll\n"
             "  for (int k = 0; k < K; ++k) sv[k] = __ldg(sr + tid + k * "
             "TPR);\n", ""),
            ("  const float r = rsqrtf(ss / (float)D + eps);\n",
             "  const float r = rsqrtf(ss / (float)D + eps);\n"
             "#pragma unroll\n"
             "  for (int k = 0; k < K; ++k) sv[k] = __ldg(sr + tid + k * "
             "TPR);\n")],
        "alt: streaming stores": [
            ("  for (int k = 0; k < K; ++k) yr[tid + k * TPR] = "
             "scaled<T>(xv[k], sv[k], r);",
             "  for (int k = 0; k < K; ++k)\n"
             "    __stcs(yr + tid + k * TPR, scaled<T>(xv[k], sv[k], r));")],
        "alt: a warp a row at few rows": [
            ("rmsnorm_rows<T, D, BT><<<grid, BT, 0, st>>>",
             "rmsnorm_rows<T, D, 32><<<(rows + 1) / 2, 64, 0, st>>>")],
    },
}


#: source -> variant name -> substitutions for the baseline's text (the
#: kernel it replaced), applied with --baseline as "baseline: <variant>"
BASELINE_VARIANTS: Dict[str, Dict[str, List[Edit]]] = {  # K2, K1 as first built
    "scan_chunk": {
        "fast pow": [
            ("__device__ __forceinline__ float xpow(float a, float b) { "
             "return powf(a, b); }",
             "__device__ __forceinline__ float xpow(float a, float b) { "
             "return __powf(a, b); }"),
            ("__device__ __forceinline__ double xpow(double a, double b) { "
             "return pow(a, b); }",
             "__device__ __forceinline__ double xpow(double a, double b) { "
             "return (double)__powf((float)a, (float)b); }")],
        "no series loads": [
            ("const int row = rowidx[s0 + t];", "const int row = t % R;"),
            ("carina::rates(u, bt, bg[s0 + t], p);",
             "carina::rates(u, bt, T(0.25), p);"),
            ("fmin((double)lens[s0 + t],", "fmin(3600.0,"),
            ("en * (double)cf[((size_t)a * E + e) * C + t];", "en * 0.4;"),
            ("en * (double)pr[s0 + t];", "en * 0.1;")],
        "loads only": [
            ("const Rates<T> r = carina::rates(u, bt, bg[s0 + t], p);",
             "const Rates<T> r = {T(1e-3) + T(1e-9) * u, bg[s0 + t] + bt, "
             "T(1e-12)};")],
    },
    "coupled_chunk": {
        "fast pow": [
            ("__device__ __forceinline__ float xpow(float a, float b) { "
             "return powf(a, b); }",
             "__device__ __forceinline__ float xpow(float a, float b) { "
             "return __powf(a, b); }"),
            ("__device__ __forceinline__ double xpow(double a, double b) { "
             "return pow(a, b); }",
             "__device__ __forceinline__ double xpow(double a, double b) { "
             "return (double)__powf((float)a, (float)b); }")],
        "no series loads": [
            ("        u = ur[0];\n        bt = br[0];\n",
             "        u = T(0.6);\n        bt = T(50);\n"),
            ("bgt = bg[L * C + t];", "bgt = T(0.25);"),
            ("off = office[(size_t)g * C + t];", "off = T(0.1);"),
            ("len = (double)lens[L * C + t];", "len = 3600.0;"),
            ("en * (double)cf[(L * E + e) * C + t];", "en * 0.4;"),
            ("en * (double)pr[L * C + t];", "en * 0.1;")],
        "loads only": [
            ("const Rates<T> r = carina::rates(u, bt, bgt, p);",
             "const Rates<T> r = {T(1e-3) + T(1e-9) * u, bgt + bt, "
             "T(1e-12)};"),
            ("r2 = carina::rates(u * f, bt, bgt, p);",
             "r2 = {r.scen_per_s, r.p_avg_w * f, r.kwh_per_s};"),
            ("carina::power_w(bgt, p.idle, p.dyn, p.alpha) / T(1000)",
             "bgt / T(1000)")],
        "one throttle step": [
            ("for (int it = 0; it < iters; ++it) {",
             "for (int it = 0; it < 1; ++it) {")],
    },
}


def _inline_headers(text: str, csrc: Path) -> str:
    """`text` with each `#include "x.cuh"` of a header in `csrc` replaced
    by the header itself (its `#pragma once` dropped), so a variant may
    edit a shared header and a baseline builds with its own headers."""
    for h in sorted(csrc.glob("*.cuh")):
        inc = f'#include "{h.name}"'
        if inc in text:
            body = h.read_text().replace("#pragma once\n", "")
            text = text.replace(inc, body, 1).replace(inc, "")
    return text


def _apply(name, label, text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"ablation {name} / {label}: a pattern "
                             f"matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def variant_sources(names=None, baseline=None) -> Dict[Tuple[str, str], str]:
    """(source, variant) -> the variant's text, "unchanged" included, for
    the sources in `names` (all by default), and "baseline" (with its own
    `BASELINE_VARIANTS`) from the checkout rooted at `baseline` if given;
    raises if a substitution does not match its source exactly once."""
    out = {}
    for name, variants in VARIANTS.items():
        if names is not None and name not in names:
            continue
        file = SOURCE_FILE.get(name, name)
        src = _inline_headers((_build.CSRC / f"{file}.cu").read_text(),
                              _build.CSRC)
        out[(name, "unchanged")] = src
        if baseline is not None:
            bdir = Path(baseline) / "src" / "repro_torch" / "csrc"
            base = _inline_headers((bdir / f"{file}.cu").read_text(), bdir)
            out[(name, "baseline")] = base
            for label, edits in BASELINE_VARIANTS.get(name, {}).items():
                out[(name, f"baseline: {label}")] = _apply(
                    name, f"baseline: {label}", base, edits)
        for label, edits in variants.items():
            out[(name, label)] = _apply(name, label, src, edits)
    return out


def _build_all(sources):
    """Compile every variant in parallel; returns the loaded libraries and
    each build's `ptxas -v` log."""
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, text) in enumerate(sources.items()):
        cu = out_dir / f"v{i}_{key[0]}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[key] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, logs = {}, {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation build {key} failed:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
        logs[key] = log
    return libs, logs


def registers(log: str) -> Dict[str, int]:
    """Mangled kernel name -> registers a thread, from a `ptxas -v` log."""
    regs, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and "Used" in ln and "registers" in ln:
            regs[name] = int(ln.split("Used", 1)[1].split()[0])
            name = None
    return regs


def blocks_per_sm(regs: int, threads: int) -> int:
    """Blocks of `threads` one H100 SM holds at `regs` registers a thread
    (no shared memory): 65,536 registers allotted in 256-register units a
    warp, 64 warps, 32 blocks."""
    warps = -(-threads // 32)
    by_regs = (65536 // (-(-regs * 32 // 256) * 256)) // warps
    return max(0, min(32, 64 // warps, by_regs))


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


def _time_k11(torch, libs, rnd, dev, stream):
    """K11 in bf16 at the training step's call: (4, 32, 2048, 64) x
    (4, 4, 2048, 64) causal, o and lse from K5's forward."""
    from repro_torch.kernels import flash_attention as fa
    b, h, hkv, s, d = 4, 32, 4, 2048, 64
    q, k, v = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    do = rnd(b, h, s, d)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty((b, h, s), device=dev)
    rows = []
    for label, fn in _variants(libs, "flash_attention_bwd",
                               "flash_attention_bwd_bf16",
                               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                               + [ctypes.c_float, ctypes.c_void_p]):
        def call(fn=fn):
            return fn(*(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk,
                                               dv, dsum)),
                      b, h, hkv, s, s, d, 1, d ** -0.5, stream)
        if call():
            raise RuntimeError(f"K11 {label}: launch failed")
        rows.append(("K11", f"({b},{h},{s},{d})x({b},{hkv},{s},{d}) causal",
                     label, _event_ms(torch, call, 10)))
    return rows


def _time_k10(torch, libs, rnd, gen, dev, stream):
    rows = []
    t, d, vocab, chunk = 8192, 2048, 32000, 8192   # the loss's K10 call
    x, w = rnd(t, d), rnd(d, vocab, std=d ** -0.5)
    lab = torch.randint(0, vocab, (t,), generator=gen, device=dev,
                        dtype=torch.int32)
    nll = torch.empty(t, device=dev)
    amax = torch.empty(t, dtype=torch.int32, device=dev)
    lse = torch.empty(t, device=dev)
    part = torch.empty((5, -(-vocab // chunk), t), device=dev)
    counter = torch.zeros(-(-t // 128), dtype=torch.int32, device=dev)
    for label, fn in _variants(libs, "xent", "blocked_xent_bf16",
                               [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p]):
        def call(fn=fn):
            counter.zero_()
            return fn(x.data_ptr(), w.data_ptr(), lab.data_ptr(),
                      nll.data_ptr(), amax.data_ptr(), lse.data_ptr(),
                      part.data_ptr(), counter.data_ptr(), t, vocab, d,
                      chunk, 1, 1, stream)
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


def _time_k9_bwd(torch, libs, rnd, dev, stream, ids_file=None):
    """K9's backward in bf16 at Moonlight-16B-A3B's train step (4 x 2,048
    tokens, top 6 of 64 experts: 832 blocks of 64 rows, routed uniformly
    at random, or as `ids_file` holds), its gate/up (d 2,048, f 1,408)
    and down (d 1,408, f 2,048) products: dX and dW by `gg_dx_sm90` /
    `gg_dw_sm90` and their variants; a baseline checkout without them by
    its `mma.sync` kernels (row tile 64)."""
    import numpy as np
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bm, routing = 64, "uniform routing"
    ids = packed_ids(4 * 2048 * 6, bm, 64, 0)
    if ids_file:
        held = np.load(ids_file)
        ids, bm, routing = held["block_ids"], int(held["block_m"]), ids_file
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=dev)
    t = ids.numel() * bm
    named = int((ids >= 0).sum())
    args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for what, d, f in (("gate/up", 2048, 1408), ("down", 1408, 2048)):
        x, dy = rnd(t, d), rnd(t, f)
        w = rnd(64, d, f, std=d ** -0.5)
        dx = torch.empty((t, d), dtype=torch.bfloat16, device=dev)
        dw = torch.empty((64, d, f), dtype=torch.bfloat16, device=dev)
        for kind, sm90, mma, ins, out in (
                ("dX", "grouped_gemm_dx_sm90", "grouped_gemm_dx_bf16",
                 (dy, w), dx),
                ("dW", "grouped_gemm_dw_sm90", "grouped_gemm_dw_bf16",
                 (x, dy), dw)):
            for (src, label), lib in libs.items():
                if src != "moe_gemm_bwd":
                    continue
                fn = getattr(lib, sm90, None)
                last = (sms,)
                if fn is None:                  # a checkout before sm90
                    fn = getattr(lib, mma)
                    last = (64, 1) if kind == "dX" else (1,)
                fn.argtypes = args[:10] + [ctypes.c_int] * (len(last) - 1) \
                    + [ctypes.c_void_p]
                fn.restype = ctypes.c_int

                def call(fn=fn, ins=ins, out=out, last=last):
                    return fn(ins[0].data_ptr(), ins[1].data_ptr(),
                              ids.data_ptr(), out.data_ptr(), t, bm, 64, d,
                              f, *last, stream)
                if call():
                    raise RuntimeError(f"K9 {kind} {label}: launch failed")
                ms = _event_ms(torch, call, 10)
                rows.append(("K9 backward", f"{kind} {what} ({t},{d}) x "
                             f"f {f}, {named} of {ids.numel()} blocks of "
                             f"{bm} ({routing}); "
                             f"{2.0 * named * bm * d * f / ms / 1e9:.0f} "
                             f"TFLOP/s", label, ms))
        del x, dy, w, dx, dw
    return rows


def _time_k12a(torch, libs, rnd, gen, dev, stream):
    """K12a's kernel in bf16 over a whole call's vocab chunks (one launch
    a chunk of 8,192 columns, last first), the (d, V) head read in place:
    TinyLlama-1.1B's train step (x (8192, 2048), head (2048, 32000), 4
    launches) and Moonlight-16B-A3B's ((2048, 163840), 20 launches):
    `xent_bwd_sm90` and its variants; a baseline checkout without it by
    its `mma.sync` kernel, and this checkout's "mma" route beside them."""
    from repro_torch.kernels import xent as k10
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    args = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    t, d, chunk = 8192, 2048, 8192
    x = rnd(t, d)
    lab = torch.randint(0, 32000, (t,), generator=gen, device=dev,
                        dtype=torch.int32)
    g = torch.full((t,), 1.0 / t, device=dev)
    dl = torch.empty((t, chunk), dtype=torch.bfloat16, device=dev)
    lo = torch.empty_like(dl)
    for name, vocab in (("TinyLlama", 32000), ("Moonlight", 163840)):
        w = rnd(d, vocab, std=d ** -0.5)
        lse = k10.blocked_xent(x, w, lab, transpose_emb=True)[2]
        ld = min(chunk, -(-vocab // 128) * 128)
        calls = []
        for (src, label), lib in libs.items():
            if src != "xent_bwd":
                continue
            fn = getattr(lib, "blocked_xent_bwd_sm90", None)
            kinds = [("", fn, sms)] if fn is not None else []
            if label in ("unchanged", "baseline") or fn is None:
                kinds.append((" (mma route)" if fn is not None else "",
                              getattr(lib, "blocked_xent_bwd_bf16"), 1))
            for suffix, f, last in kinds:
                f.argtypes = args
                f.restype = ctypes.c_int
                calls.append((label + suffix, f, last))
        for label, fn, last in calls:
            def call(fn=fn, last=last):
                err = 0
                for base in reversed(range(0, vocab, chunk)):
                    err = err or fn(x.data_ptr(), w.data_ptr(),
                                    lab.data_ptr(), lse.data_ptr(),
                                    g.data_ptr(), dl.data_ptr(),
                                    lo.data_ptr(), t, vocab, d, base,
                                    min(chunk, vocab - base), ld, 1, last,
                                    stream)
                return err
            if call():
                raise RuntimeError(f"K12a {name} {label}: launch failed")
            ms = _event_ms(torch, call, 5)
            rows.append(("K12a", f"{name} x ({t},{d}) head ({d},{vocab}), "
                         f"{-(-vocab // chunk)} launches; "
                         f"{2.0 * t * vocab * d / ms / 1e9:.0f} TFLOP/s",
                         label, ms))
        del w, lse
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


def _physics(torch, n, dtype, dev, gen):
    """Per-lane scalars of OEM case 1's calibrated workload and machine
    (dyn and alpha spread per lane); n_scen so large that no lane
    finishes inside a chunk."""
    from repro_torch import carina
    wl, m = carina.calibrate_workload(carina.OEM_CASE_1,
                                      carina.MachineProfile())

    def uni(lo, hi):
        return (torch.rand(n, generator=gen, device=dev,
                           dtype=torch.float64) * (hi - lo) + lo).to(dtype)

    def full(v):
        return torch.full(n, v, dtype=dtype, device=dev)
    return (full(1e15), full(wl.rate_at_full), full(wl.batch_overhead_s),
            full(m.idle_w), uni(0.8, 1.2) * m.dyn_w, uni(1.2, 2.0),
            full(m.gamma), full(m.overhead_w_frac))


def k2_inputs(torch, dtype, dev, gen, A=100_000, R=24, C=96, E=1):
    """K2's synthetic chunk at chip_smoke.py's captured shape (B = 1):
    every lane runs all C slots (remaining 1e15 scenarios)."""
    def uni(shape, lo, hi):
        return (torch.rand(shape, generator=gen, device=dev,
                           dtype=torch.float64) * (hi - lo) + lo).to(dtype)
    s0 = torch.randint(0, R, (A, 1), generator=gen, device=dev)
    rowidx = ((s0 + torch.arange(C, device=dev)) % R).to(torch.int32)
    ins = (uni((A, R, 1), 0.35, 0.95),
           torch.full((A, R, 1), 50.0, dtype=dtype, device=dev), rowidx,
           uni((A, C), 0.0, 0.5), uni((A, E, C), 0.3, 0.6),
           uni((A, C), 0.0, 0.2),
           torch.full((A, C), 3600.0, dtype=dtype, device=dev))
    z = torch.zeros(A, dtype=torch.float64, device=dev)
    state = (z + 1e15, z, z, torch.zeros((A, E), dtype=torch.float64,
                                         device=dev), z)
    return ins + state + _physics(torch, (A,), dtype, dev, gen)


def k1_inputs(torch, dtype, dev, gen, cap, G=512, Lp=8, C=96, E=1):
    """K1's synthetic chunk at chip_smoke.py's captured shape (B = 1, the
    benchmark's 8-lane groups, office draw 0.05-0.12 kW): every lane runs
    all C slots."""
    def uni(shape, lo, hi):
        return (torch.rand(shape, generator=gen, device=dev,
                           dtype=torch.float64) * (hi - lo) + lo).to(dtype)
    ins = (uni((G, Lp, C, 1), 0.35, 0.95),
           torch.full((G, Lp, C, 1), 50.0, dtype=dtype, device=dev),
           uni((G, Lp, C), 0.0, 0.5), uni((G, Lp, E, C), 0.3, 0.6),
           uni((G, Lp, C), 0.0, 0.2),
           torch.full((G, Lp, C), 3600.0, dtype=dtype, device=dev),
           torch.full((G,), cap, dtype=dtype, device=dev),
           uni((G, C), 0.05, 0.12))
    z = torch.zeros((G, Lp), dtype=torch.float64, device=dev)
    state = (z + 1e15, z, z, torch.zeros((G, Lp, E), dtype=torch.float64,
                                         device=dev), z, z)
    return ins + state + _physics(torch, (G, Lp), dtype, dev, gen)


def _time_k2(torch, libs, gen, dev, stream):
    """K2 at A = 100,000 lanes, C = 96 slots, R = 24 rows, B = E = 1, in
    fp64 and fp32 (the mixed plan's instance)."""
    rows = []
    for dtype, fname in ((torch.float64, "scan_chunk_f64"),
                         (torch.float32, "scan_chunk_f32")):
        args = k2_inputs(torch, dtype, dev, gen)
        out = tuple(torch.empty_like(s) for s in args[7:12])
        ptrs = [x.data_ptr() for x in args + out]
        A, R, _ = args[0].shape
        C, E = args[2].shape[1], args[4].shape[1]
        for label, fn in _variants(libs, "scan_chunk", fname,
                                   [ctypes.c_void_p] * 25
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p]):
            def call(fn=fn):
                return fn(*ptrs, A, R, 1, C, E, stream)
            if call():
                raise RuntimeError(f"K2 {label}: launch failed")
            rows.append(("K2", f"{str(dtype)[6:]} A {A} C {C} R {R} B 1 "
                         f"E {E}", label, _event_ms(torch, call, 10)))
        del args, out
    return rows


def _time_k1(torch, libs, gen, dev, stream):
    """K1 at (G, Lp, C, B) = (512, 8, 96, 1), E = 1, 4 throttle steps, in
    fp64 and fp32, under the benchmark's 2.0 kW cap and under a 1.0 kW
    cap that binds in every slot."""
    rows = []
    for cap in (2.0, 1.0):
        for dtype, fname in ((torch.float64, "coupled_chunk_f64"),
                             (torch.float32, "coupled_chunk_f32")):
            args = k1_inputs(torch, dtype, dev, gen, cap)
            out = tuple(torch.empty_like(s) for s in args[8:14])
            ptrs = [x.data_ptr() for x in args + out]
            G, Lp, C, B = args[0].shape
            E = args[3].shape[2]
            for label, fn in _variants(
                    libs, "coupled_chunk", fname,
                    [ctypes.c_void_p] * 28 + [ctypes.c_int] * 6
                    + [ctypes.c_double, ctypes.c_void_p]):
                def call(fn=fn):
                    return fn(*ptrs, G, Lp, C, B, E, 4, 1e-6, stream)
                if call():
                    raise RuntimeError(f"K1 {label}: launch failed")
                rows.append(("K1", f"{str(dtype)[6:]} ({G},{Lp},{C},{B}) "
                             f"E {E} cap {cap} kW", label,
                             _event_ms(torch, call, 10)))
            steps = getattr(libs[("coupled_chunk", "unchanged")],
                            f"coupled_chunk_steps_{fname[-3:]}", None)
            if steps is not None:
                hist = torch.zeros(5, dtype=torch.int32, device=dev)
                steps.argtypes = ([ctypes.c_void_p] * 28
                                  + [ctypes.c_int] * 6
                                  + [ctypes.c_double] + [ctypes.c_void_p] * 2)
                steps(*ptrs, G, Lp, C, B, E, 4, 1e-6, hist.data_ptr(),
                      stream)
                print(f"K1 {str(dtype)[6:]} cap {cap} kW: (group, slot) "
                      f"pairs by throttle steps 0-4 {hist.tolist()}",
                      flush=True)
            del args, out
    return rows


def _time_k7(torch, libs, dev, stream):
    """K7 at the RG-LRU's (1, 2048, 4096) in fp32 and with bf16 inputs and
    at Falcon-Mamba-7B's flattened (1, 916, 131072) in fp32, the chunks
    from `scan_plan`; the baseline with its own signature (no workspace,
    one thread a chain).  Each variant's first call is held against the
    plain version (a removed part gives a wrong result by design)."""
    from repro_torch.kernels import ssm_scan as k7
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(7)
    for b, t, c, dtype in ((1, 2048, 4096, torch.float32),
                           (1, 2048, 4096, torch.bfloat16),
                           (1, 916, 131072, torch.float32)):
        a = (0.5 + 0.5 * torch.rand((b, t, c), generator=gen, device=dev)
             ).to(dtype)
        x = (0.1 * torch.randn((b, t, c), generator=gen, device=dev)
             ).to(dtype)
        hs = torch.empty((b, t, c), device=dev)
        hf = torch.empty((b, c), device=dev)
        phs, _ = k7.ssm_scan_plain(a, x)
        scale = float(phs.abs().max())
        chunks, steps = k7.scan_plan(b, t, c, sms)
        name = k7._FNS[dtype]
        for (src, label), lib in libs.items():
            if src != "ssm_scan":
                continue
            fn = getattr(lib, name)
            if label == "baseline":
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
                    [ctypes.c_void_p]

                def call(fn=fn):
                    return fn(a.data_ptr(), x.data_ptr(), hs.data_ptr(),
                              hf.data_ptr(), b, t, c, stream)
            else:
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
                    [ctypes.c_void_p]
                lib.ssm_scan_workspace.argtypes = [ctypes.c_int] * 3
                lib.ssm_scan_workspace.restype = ctypes.c_size_t
                work = torch.empty(lib.ssm_scan_workspace(b, c, chunks),
                                   dtype=torch.uint8, device=dev)

                def call(fn=fn, work=work):
                    return fn(a.data_ptr(), x.data_ptr(), hs.data_ptr(),
                              hf.data_ptr(), work.data_ptr(), b, t, c,
                              chunks, steps, stream)
            if call():
                raise RuntimeError(f"K7 {label}: launch failed")
            torch.cuda.synchronize()
            err = float((hs - phs).abs().max()) / scale
            rows.append(("K7", f"({b},{t},{c}) {str(dtype)[6:]}, {chunks} "
                         f"chunks of {steps}", label,
                         _event_ms(torch, call, 20)))
            print(f"K7 ({b},{t},{c}) {str(dtype)[6:]} {label}: hs vs plain "
                  f"{err:.3e} of max |h|", flush=True)
        del a, x, hs, phs
    return rows


K12C_TOL = 1e-5  # of max |y|: K12c's bar against its plain version


def _time_k12c(torch, libs, dev, stream):
    """K12c at Falcon-Mamba-7B's prefills (d_inner 8,192, N 16, bf16 x, B
    and C, fp32 dt and A) of 916 and 3,100 tokens; each variant's first
    call held against the plain version, the kernel and an "alt:" one at
    K12c's bar of 1e-5 of max |y| (a removed part gives a wrong result by
    design, and is only printed)."""
    from repro_torch.kernels import selective_scan as k12c
    rows = []
    gen = torch.Generator(device=dev).manual_seed(12)
    di, n = 8192, 16
    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).expand(
        di, n).contiguous()
    for t in (916, 3100):
        dt = torch.nn.functional.softplus(
            torch.randn((1, t, di), generator=gen, device=dev) - 4.0)
        bm, cm = (torch.randn((1, t, n), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        x = torch.randn((1, t, di), generator=gen, device=dev).to(
            torch.bfloat16)
        y = torch.empty((1, t, di), device=dev)
        hf = torch.empty((1, di, n), device=dev)
        py, _ = k12c.selective_scan_plain(dt, bm, cm, x, A)
        scale = float(py.abs().max())
        argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        for label, fn in _variants(libs, "selective_scan",
                                   "selective_scan_bf16", argtypes):
            def call(fn=fn):
                return fn(dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                          x.data_ptr(), A.data_ptr(), y.data_ptr(),
                          hf.data_ptr(), 1, t, di, n, stream)
            if call():
                raise RuntimeError(f"K12c {label}: launch failed")
            torch.cuda.synchronize()
            err = float((y - py).abs().max()) / scale
            print(f"K12c (1,{t},{di}) {label}: y vs plain {err:.3e} of max "
                  f"|y|", flush=True)
            if (label == "unchanged" or label.startswith("alt:")) and \
                    not err <= K12C_TOL:
                raise RuntimeError(f"K12c {label}: y vs plain {err:.3e} of "
                                   f"max |y|, over {K12C_TOL}")
            rows.append(("K12c", f"(1,{t},{di}) x N {n} bf16", label,
                         _event_ms(torch, call, 20)))
        del dt, bm, cm, x, y, py
    return rows


def _time_k8(torch, libs, rnd, dev, stream):
    """K8 in bf16 at a decode tick's 4 rows, a 916-token prefill's rows,
    the loss's 8,192 rows (d 2048) and MLA's kv_norm rows (d 512) at a
    tick and a prefill, each in the layout `launch_plan` picks; the
    baseline with its own signature (a warp a row, 8 rows a block)."""
    from repro_torch.kernels import rmsnorm as k8
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for t, d in ((4, 2048), (916, 2048), (8192, 2048), (4, 512), (916, 512)):
        x, s = rnd(t, d), rnd(d, std=0.1)
        y = torch.empty_like(x)
        tpr, rpb = k8.launch_plan(t, d, sms, 2, True)
        for (src, label), lib in libs.items():
            if src != "rmsnorm":
                continue
            fn = lib.rmsnorm_bf16_bf16
            if label == "baseline":
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
                    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

                def call(fn=fn):
                    return fn(x.data_ptr(), s.data_ptr(), y.data_ptr(), t, d,
                              1e-6, 1, stream)
            else:
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
                    [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]

                def call(fn=fn):
                    return fn(x.data_ptr(), s.data_ptr(), y.data_ptr(), t, d,
                              1e-6, tpr, rpb, 1, stream)
            if call():
                raise RuntimeError(f"K8 {label}: launch failed")
            rows.append(("K8", f"({t},{d}) bf16, {tpr} threads a row, {rpb} "
                         f"rows a block", label, _event_ms(torch, call, 50)))
    return rows


def spills(log: str) -> Dict[str, str]:
    """Mangled kernel name -> its `ptxas -v` spill line, where it spills."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and "spill" in ln and not ln.strip().startswith(
                "0 bytes stack frame, 0 bytes spill stores"):
            out[name] = ln.strip()
    return out


def _registers_line(logs, src, only=None):
    """`ptxas -v` registers (and spills) of every kernel of each built
    variant (those whose name holds `only`, if given)."""
    lines = []
    for (name, label), log in logs.items():
        if name == src:
            parts = []
            spilled = spills(log)
            for k, n in registers(log).items():
                if only and only not in k:
                    continue
                m = (re.search(r"_cu_[0-9a-f]{8}\d+([A-Za-z_]+)I(.*?)EEv", k)
                     or re.search(r"(gg_\w+?_sm90)()E", k)
                     or re.search(r"(xent_bwd_sm90)I(.*?)EEv", k))
                extra = f" ({spilled[k]})" if k in spilled else ""
                tmpl = f"<{m.group(2)}>" if m and m.group(2) else ""
                parts.append(f"{m.group(1)}{tmpl} {n}{extra}" if m
                             else f"{k} {n}{extra}")
            lines.append(f"{src} {label}: " + ", ".join(parts))
    return lines


#: the `<source>_plan` arguments before (f64, out) at the timed shapes
PLAN_ARGS = {"scan_chunk": (100_000, 1), "coupled_chunk": (512, 8)}


def _occupancy(libs, logs, names):
    """One line per built variant of K2 and K1: `ptxas -v` registers of
    each kernel's E = 1 instance (K1: B = 1, a warp's groups, the power
    terms shared out over the lane's replicas) and the
    blocks an SM holds at the timed shape (the library's own
    `<source>_plan`, CUDA's occupancy API, where it has one; else from
    the registers at 128 threads a block)."""
    lines = []
    for (src, label), log in logs.items():
        if src not in names or src not in PLAN_ARGS:
            continue
        parts = []
        for kname, n in registers(log).items():
            m = re.search(r"kernelI([df])(?:Li(\d+)E)?((?:Lb\dE)*)", kname)
            if (m is None or m.group(2) not in (None, "1")
                    or m.group(3) not in ("", "Lb1ELb1ELb1E")):
                continue
            f64 = m.group(1) == "d"
            fn = getattr(libs[(src, label)], f"{src}_plan", None)
            if fn is not None:
                out = (ctypes.c_int * 4)()
                fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
                fn(*PLAN_ARGS[src], int(f64), out)
                per_sm = f"{out[3]} blocks/SM (occupancy API)"
            else:
                per_sm = (f"{blocks_per_sm(n, 128)} blocks/SM of 128 "
                          f"(from registers)")
            parts.append(f"{'f64' if f64 else 'f32'} (E = 1) {n} "
                         f"registers, {per_sm}")
        lines.append(f"{src} {label}: " + "; ".join(parts))
    return lines


def main(argv=None) -> int:
    import torch
    args = list(argv if argv is not None else sys.argv[1:])
    baseline = None
    if "--baseline" in args:
        i = args.index("--baseline")
        baseline = args[i + 1]
        del args[i:i + 2]
    ids_file = None
    if "--ids" in args:
        i = args.index("--ids")
        ids_file = args[i + 1]
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
    libs, logs = _build_all(variant_sources(names, baseline))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std
                ).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    timers = {"flash_attention": lambda: _time_k5(torch, libs, rnd, dev,
                                                  stream),
              "flash_attention_bwd": lambda: _time_k11(torch, libs, rnd, dev,
                                                       stream),
              "xent": lambda: _time_k10(torch, libs, rnd, gen, dev, stream),
              "moe_gemm": lambda: _time_k9(torch, libs, rnd, dev, stream),
              "moe_gemm_bwd": lambda: _time_k9_bwd(torch, libs, rnd, dev,
                                                   stream, ids_file),
              "xent_bwd": lambda: _time_k12a(torch, libs, rnd, gen, dev,
                                             stream),
              "decode_attention": lambda: _time_k6(torch, libs, rnd, dev,
                                                   stream),
              "scan_chunk": lambda: _time_k2(torch, libs, gen, dev, stream),
              "coupled_chunk": lambda: _time_k1(torch, libs, gen, dev,
                                                stream),
              "ssm_scan": lambda: _time_k7(torch, libs, dev, stream),
              "rmsnorm": lambda: _time_k8(torch, libs, rnd, dev, stream),
              "selective_scan": lambda: _time_k12c(torch, libs, dev,
                                                   stream)}
    for line in _occupancy(libs, logs, names):
        print(line, flush=True)
    for src in ("ssm_scan", "rmsnorm", "flash_attention_bwd",
                "selective_scan"):
        if src in names:
            for line in _registers_line(logs, src):
                print(line, flush=True)
    if "moe_gemm_bwd" in names:
        for line in _registers_line(logs, "moe_gemm_bwd", only="gg_d"):
            print(line, flush=True)
    if "xent_bwd" in names:
        for line in _registers_line(logs, "xent_bwd", only="xent_bwd_"):
            print(line, flush=True)
    rows = [row for name in names for row in timers[name]()]
    for kernel, shape, label, ms in rows:
        print(f"{kernel} {shape} {label}: {ms:.4f} ms", flush=True)
    print(json.dumps({"ablation": [dict(kernel=k, shape=s, variant=lbl,
                                        ms=ms) for k, s, lbl, ms in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
