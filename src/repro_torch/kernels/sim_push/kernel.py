"""Wrappers of the simulator's push K7 (``csrc/sim_push.cu``): its
messages and their sum.

``sim_messages(sel, pid, sent, deg, indptr, indices, wgt, owner, n_e)``
expands a diffusion of the nodes ``sel`` (pushed by the PIDs ``pid``,
with the fluid ``sent``) into its ``n_e`` messages, node by node and each
node's out-edges in CSR order: the key of each (its destination d where
the pushing PID owns d, else that PID's outbox entry N + 1 + pid·N + d),
its value ``sent·w`` and, for a remote one, its |value| (0 for a local
one).  :func:`sim_messages_plain` is the same in torch.

``sim_push(state, key, msg)`` adds each message ``msg[e]`` into
``state[key[e]]``, in place and in message order for every key: the
reference simulator's ``np.add.at`` (``repro.core.simulator``,
``_diffuse_node`` and ``_diffuse_batch``).  The simulator keeps the fluid
and the K outboxes in one float64 buffer — node d's fluid at d, a spare
0 at N, PID k's outbox entry for d at N + 1 + k·N + d — so one call does
both scatters of a diffusion, the local one into ``f`` and the remote one
into the outbox, for every PID that diffuses in it.  :func:`sim_push_plain` is
``index_add_`` on CPU tensors, a loop in index order, which gives
``np.add.at``'s bits.  On the card ``index_add_`` would add with float64
atomics in an order that changes from run to run: K7 ranks each message
in its key's count with an integer atomic, gathers each key's message
indices (in a row of 4 a key, or a bucket for longer keys), sorts them
(a bucket by merges, m log m for m messages) and adds the messages in
that order with no float atomics, so a run replays bit for bit
(``csrc/sim_push.cu`` says how).

Each kernel is one cooperative launch.  The scratch it needs lives in one
workspace a device (:func:`_workspace`), grown and never shrunk:
sim_push's counts (an int32 a state entry, zero between pushes: each push
leaves them so) and rows (4 int32 a state entry: the indices of the key's
first messages, any values between pushes), 20 bytes a state entry in
all (377 MB for the simulator's 9·2²¹ + 1 entries at K=8), and both
kernels' per-call scratch (a quarter over the largest call so far).  When
a call comes on another stream than the last, that stream first waits for
the last one's work, so two streams never share the workspace at once.

Each wrapper launches its kernel for tensors on the card and runs its
plain version for tensors on the CPU; each counts its launches apart
(``LAUNCHES["sim_messages"]``, ``LAUNCHES["sim_push"]``).  An empty push
launches nothing and counts nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .._build import LAUNCHES, check, library, stream_handle

__all__ = ["sim_messages", "sim_messages_plain", "sim_push",
           "sim_push_plain"]


def sim_push_plain(state: torch.Tensor, key: torch.Tensor,
                   msg: torch.Tensor) -> None:
    """K7's contract in torch, in place (index order per key on CPU
    tensors)."""
    state.index_add_(0, key, msg)


def sim_messages_plain(sel: torch.Tensor, pid: torch.Tensor,
                       sent: torch.Tensor, deg: torch.Tensor,
                       indptr: torch.Tensor, indices: torch.Tensor,
                       wgt: torch.Tensor, owner: torch.Tensor, n_e: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`sim_messages`'s contract in torch: ``(key int32, msg,
    rabs)``."""
    dev, n = sel.device, owner.numel()
    lens = deg.index_select(0, sel)
    node = torch.repeat_interleave(torch.arange(sel.numel(), device=dev),
                                   lens, output_size=n_e)
    first = indptr.index_select(0, sel) - (torch.cumsum(lens, 0) - lens)
    edge = first.index_select(0, node) + torch.arange(n_e, device=dev)
    dst = indices.index_select(0, edge)
    p = pid.index_select(0, node)
    msg = sent.index_select(0, node) * wgt.index_select(0, edge)
    local = owner.index_select(0, dst) == p
    key = torch.where(local, dst, dst + (n + 1) + p * n).to(torch.int32)
    return key, msg, torch.where(local, 0.0, msg.abs())


_P = ctypes.c_void_p
_I = ctypes.c_int64
# a push's messages index int32 slots in the kernel
MAX_MESSAGES = 2**30 - 1
_WORKSPACES: Dict[int, Dict[str, object]] = {}


def _lib() -> ctypes.CDLL:
    lib = library("sim_push")
    if lib.sim_push.argtypes is None:
        lib.sim_push.argtypes = [_P] * 3 + [_I, _I] + [_P] * 4
        lib.sim_push.restype = ctypes.c_int
        lib.sim_messages.argtypes = [_P] * 4 + [_I] + [_P] * 4 + [_I] + [
            _P] * 3 + [_I, _P, _P]
        lib.sim_messages.restype = ctypes.c_int
        for fn, n_args in ((lib.sim_push_rows, 1), (lib.sim_push_scratch, 1),
                           (lib.sim_messages_scratch, 2)):
            fn.argtypes = [_I] * n_args
            fn.restype = _I
    return lib


def _workspace(device: torch.device,
               stream: Optional[int] = None) -> Dict[str, object]:
    """K7's scratch on ``device``: ``count`` (int32, one a state entry,
    zero between pushes), ``rows`` (int32, four a state entry), ``push``
    (int32) and ``messages`` (int64).  Given the raw ``stream`` a call
    runs on, orders it after the stream of the call before."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    ws = _WORKSPACES.setdefault(index, {})
    last = ws.get("stream")
    if stream is not None and stream != last:
        if last is not None:
            now = torch.cuda.ExternalStream(stream, device=index)
            now.wait_stream(torch.cuda.ExternalStream(last, device=index))
            for t in ws.values():
                if torch.is_tensor(t):
                    t.record_stream(now)
        ws["stream"] = stream
    return ws


def _grown(ws: Dict[str, object], name: str, n: int, dtype,
           device: torch.device, slack: bool = True,
           zero: bool = False) -> torch.Tensor:
    """``ws[name]``, reallocated when it holds fewer than ``n`` entries:
    with a quarter more (``slack``) for per-call scratch, zeroed for
    ``zero``."""
    t = ws.get(name)
    if t is None or t.numel() < n:
        if slack:  # room to grow in, fewer reallocations
            n += n // 4
        t = ws[name] = (torch.zeros if zero else torch.empty)(
            n, dtype=dtype, device=device)
    return t


def _check(dev, **tensors) -> None:
    for name, (t, dtype) in tensors.items():
        if t.device != dev or t.dtype != dtype or t.dim() != 1:
            raise ValueError(
                f"{name}: expected a 1-d {dtype} tensor on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sim_messages(sel: torch.Tensor, pid: torch.Tensor, sent: torch.Tensor,
                 deg: torch.Tensor, indptr: torch.Tensor,
                 indices: torch.Tensor, wgt: torch.Tensor,
                 owner: torch.Tensor, n_e: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``n_e`` messages of the nodes ``sel`` (int64), pushed by
    ``pid`` (int64) with the fluid ``sent`` (float64): ``(key int32, msg,
    rabs)`` over the CSR ``indptr``, ``indices`` (int64), ``wgt``
    (float64), with the out-degrees ``deg`` (int64) and the owner map
    ``owner`` (int32).  ``n_e`` must be the sum of ``deg[sel]``."""
    if sel.device.type == "cpu":
        return sim_messages_plain(sel, pid, sent, deg, indptr, indices, wgt,
                                  owner, n_e)
    if sel.device.type != "cuda":
        raise ValueError(f"no kernel for device {sel.device}")
    _check(sel.device, sel=(sel, torch.int64), pid=(pid, torch.int64),
           sent=(sent, torch.float64), deg=(deg, torch.int64),
           indptr=(indptr, torch.int64), indices=(indices, torch.int64),
           wgt=(wgt, torch.float64), owner=(owner, torch.int32))
    if pid.numel() != sel.numel() or sent.numel() != sel.numel():
        raise ValueError("sel, pid and sent must have one entry a node")
    dev = sel.device
    key = torch.empty(n_e, dtype=torch.int32, device=dev)
    msg = torch.empty(n_e, dtype=torch.float64, device=dev)
    rabs = torch.empty(n_e, dtype=torch.float64, device=dev)
    if n_e == 0:
        return key, msg, rabs
    lib, n_sel, stream = _lib(), sel.numel(), stream_handle(dev)
    scratch = _grown(_workspace(dev, stream), "messages",
                     lib.sim_messages_scratch(n_sel, n_e), torch.int64, dev)
    err = lib.sim_messages(
        sel.data_ptr(), pid.data_ptr(), sent.data_ptr(), deg.data_ptr(),
        n_sel, indptr.data_ptr(), indices.data_ptr(), wgt.data_ptr(),
        owner.data_ptr(), owner.numel(), key.data_ptr(), msg.data_ptr(),
        rabs.data_ptr(), n_e, scratch.data_ptr(), stream)
    check(lib, err, "sim_messages")
    LAUNCHES["sim_messages"] += 1
    return key, msg, rabs


def sim_push(state: torch.Tensor, key: torch.Tensor,
             msg: torch.Tensor) -> None:
    """Add ``msg`` (float64 ``[E]``) into ``state`` (float64, contiguous)
    at ``key`` (int32 ``[E]``, each in ``[0, state.numel())``), in message
    order for every key.  On the card a key outside the state stops the
    kernel (a device-side trap)."""
    if key.dtype != torch.int32:
        raise ValueError(f"key: expected int32, got {key.dtype}")
    if state.device.type == "cpu":
        sim_push_plain(state, key, msg)
        return
    if state.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.device}")
    e = key.numel()
    _check(state.device, state=(state, torch.float64),
           key=(key, torch.int32), msg=(msg, torch.float64))
    if msg.numel() != e:
        raise ValueError(f"key has {e} entries, msg {msg.numel()}")
    if state.numel() >= 2**31:
        raise ValueError(f"state has {state.numel()} entries: K7's keys "
                         "are int32")
    if e > MAX_MESSAGES:
        raise ValueError(f"{e} messages: K7 takes at most {MAX_MESSAGES} "
                         "a push")
    if e == 0:
        return
    lib, dev = _lib(), state.device
    stream = stream_handle(dev)
    ws = _workspace(dev, stream)
    count = _grown(ws, "count", state.numel(), torch.int32, dev, slack=False,
                   zero=True)
    rows = _grown(ws, "rows", lib.sim_push_rows(state.numel()), torch.int32,
                  dev, slack=False)
    scratch = _grown(ws, "push", lib.sim_push_scratch(e), torch.int32, dev)
    err = lib.sim_push(key.data_ptr(), msg.data_ptr(), state.data_ptr(),
                       state.numel(), e, count.data_ptr(), rows.data_ptr(),
                       scratch.data_ptr(), stream)
    check(lib, err, "sim_push")
    LAUNCHES["sim_push"] += 1
