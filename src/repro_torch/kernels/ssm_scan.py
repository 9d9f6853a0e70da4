"""K7: the diagonal linear recurrence h_t = a_t * h_{t-1} + b_t from
h_{-1} = 0 over a, b (B, T, C) -> (hs (B, T, C) fp32, h_final (B, C)
fp32), the math in fp32 whatever the input dtype.

It is the counterpart of the reference's Pallas kernel
`src/repro/kernels/ssm_scan.py::ssm_scan` (and of its oracle
`kernels/ref.py::ssm_scan_ref`).  The reference pads T and C with
a = 1, b = 0, so padded steps never change h; the port's kernel runs each
chain over exactly T steps and needs no padding.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/ssm_scan.cu: one thread a (b, c) chain, each chain cut into the
time chunks `scan_plan` gives, scanned chunk-parallel where there is
more than one) and counts the call in `launches`; on a CPU tensor it runs
`ssm_scan_plain`.  Any other device raises.  `chunk` and `block_c` are the
reference's time-chunk and channel-block sizes, kept for signature parity
and checked: the CUDA kernel uses neither (its chunks come from the card,
and it fixes its own block of channels).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches on CUDA tensors since import (or the last reset)
launches = 0

_FNS = {torch.bfloat16: "ssm_scan_bf16_f32", torch.float32: "ssm_scan_f32_f32"}
#: chains a block (csrc/ssm_scan.cu kThreads)
THREADS = 128
#: threads an SM the plan aims at: about the 31 warps an SM of a
#: Falcon-Mamba-7B call, which streams near the card's rate in one chunk
CHAINS_PER_SM = 1024
#: steps a chunk at least, in whole groups of the kernel's 8-step unroll
MIN_STEPS, STEP_GROUP = 16, 8
#: chunks a chain at most (phase 3 carries over every earlier chunk)
MAX_CHUNKS = 1024


def scan_plan(b: int, t: int, c: int, sms: int) -> Tuple[int, int]:
    """(chunks, steps a chunk) of each chain's T steps on a card of `sms`
    SMs: 1 chunk of T where the b * c chains already give half of
    CHAINS_PER_SM an SM; else chunks of a whole number of STEP_GROUPs, at
    least MIN_STEPS, enough of them for the chains x chunks threads to
    reach CHAINS_PER_SM an SM (at most MAX_CHUNKS).  The chunks cover T
    exactly, the last one short."""
    chains = b * c
    if chains * 2 >= CHAINS_PER_SM * sms or t < 2 * MIN_STEPS:
        return 1, t
    want = -(-CHAINS_PER_SM * sms // chains)
    steps = max(MIN_STEPS, -(-t // want), -(-t // MAX_CHUNKS))
    steps = -(-steps // STEP_GROUP) * STEP_GROUP
    return -(-t // steps), steps


def ssm_scan_plain(a: torch.Tensor,
                   b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as a loop over T on tensors (any device): the
    plain version the kernel is held against."""
    bsz, t, c = a.shape
    hs = torch.empty((bsz, t, c), dtype=torch.float32, device=a.device)
    h = torch.zeros((bsz, c), dtype=torch.float32, device=a.device)
    for i in range(t):
        h = a[:, i].float() * h + b[:, i].float()
        hs[:, i] = h
    return hs, h


def ssm_scan_chunked_plain(a: torch.Tensor, b: torch.Tensor, steps: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunk decomposition in tensor ops (any device; no main
    path calls it): each chunk of `steps` steps' product P and end state H
    from 0, the state carried into each chunk over the earlier ones
    (exactly H where the carried state is 0), and every chunk rerun from
    its carried state."""
    bsz, t, c = a.shape
    a, b = a.float(), b.float()
    hs = torch.empty((bsz, t, c), dtype=torch.float32, device=a.device)
    h = torch.zeros((bsz, c), dtype=torch.float32, device=a.device)
    run = h
    for t0 in range(0, t, steps):
        t1 = min(t0 + steps, t)
        run = h
        for i in range(t0, t1):
            run = a[:, i] * run + b[:, i]
            hs[:, i] = run
        if t1 < t:
            p, e = torch.ones_like(h), torch.zeros_like(h)
            for i in range(t0, t1):
                p, e = p * a[:, i], a[:, i] * e + b[:, i]
            h = torch.where(h == 0, e, p * h + e)
    return hs, run


def _check(a: torch.Tensor, b: torch.Tensor, chunk: int, block_c: int):
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"ssm_scan takes a and b of one shape (B, T, C), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _FNS or b.dtype != a.dtype:
        raise TypeError(f"ssm_scan takes bf16 or fp32 a and b of one dtype, "
                        f"got {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError("ssm_scan inputs must be on one device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ssm_scan inputs must be contiguous")
    if chunk < 1 or block_c < 1:
        raise ValueError(f"ssm_scan takes positive chunk and block_c, got "
                         f"{chunk} and {block_c}")
    if a.requires_grad or b.requires_grad:
        raise RuntimeError("ssm_scan is forward only")


def ssm_scan(a: torch.Tensor, b: torch.Tensor, *, chunk: int = 128,
             block_c: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, T, C) bf16 or fp32 -> (hs (B, T, C), h_final (B, C)),
    both fp32."""
    _check(a, b, chunk, block_c)
    if a.device.type == "cpu":
        return ssm_scan_plain(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"ssm_scan runs on CUDA or CPU tensors, not "
                           f"{a.device}")
    bsz, t, c = a.shape
    if bsz > 65535:
        raise ValueError(f"ssm_scan takes B up to 65535, got {bsz}")
    hs = torch.empty((bsz, t, c), dtype=torch.float32, device=a.device)
    hf = torch.zeros((bsz, c), dtype=torch.float32, device=a.device)
    if bsz == 0 or t == 0 or c == 0:
        return hs, hf
    chunks, steps = scan_plan(bsz, t, c, _build.sm_count(a.device))
    lib = _library()
    work = torch.empty(lib.ssm_scan_workspace(bsz, c, chunks),
                       dtype=torch.uint8, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FNS[a.dtype])(
            a.data_ptr(), b.data_ptr(), hs.data_ptr(), hf.data_ptr(),
            work.data_ptr(), bsz, t, c, chunks, steps, stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return hs, hf


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.library("ssm_scan")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ssm_scan_workspace.argtypes = [ctypes.c_int] * 3
    lib.ssm_scan_workspace.restype = ctypes.c_size_t
    return lib
