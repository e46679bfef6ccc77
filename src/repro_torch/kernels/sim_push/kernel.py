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
atomics in an order that changes from run to run: K7 sorts the keys
stably and gives each run of equal keys one thread (no atomics), so a run
replays bit for bit.

Each wrapper launches its kernel for tensors on the card and runs its
plain version for tensors on the CPU; each counts its launches apart
(``LAUNCHES["sim_messages"]``, ``LAUNCHES["sim_push"]``).  An empty push
launches nothing and counts nothing.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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


def _lib() -> ctypes.CDLL:
    lib = library("sim_push")
    if lib.sim_push.argtypes is None:
        lib.sim_push.argtypes = [_P] * 4 + [_I, _P]
        lib.sim_push.restype = ctypes.c_int
        lib.sim_messages.argtypes = [_P] * 4 + [_I] + [_P] * 4 + [_I] + [
            _P] * 3 + [_I, _P]
        lib.sim_messages.restype = ctypes.c_int
    return lib


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
    ``owner`` (int32)."""
    if sel.device.type == "cpu":
        return sim_messages_plain(sel, pid, sent, deg, indptr, indices, wgt,
                                  owner, n_e)
    if sel.device.type != "cuda":
        raise ValueError(f"no kernel for device {sel.device}")
    _check(sel.device, sel=(sel, torch.int64), pid=(pid, torch.int64),
           sent=(sent, torch.float64), deg=(deg, torch.int64),
           indptr=(indptr, torch.int64), indices=(indices, torch.int64),
           wgt=(wgt, torch.float64), owner=(owner, torch.int32))
    n_sel, n = sel.numel(), owner.numel()
    if pid.numel() != n_sel or sent.numel() != n_sel:
        raise ValueError("sel, pid and sent must have one entry a node")
    dev = sel.device
    key = torch.empty(n_e, dtype=torch.int32, device=dev)
    msg = torch.empty(n_e, dtype=torch.float64, device=dev)
    rabs = torch.empty(n_e, dtype=torch.float64, device=dev)
    if n_e == 0:
        return key, msg, rabs
    base = torch.zeros(n_sel + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg.index_select(0, sel), 0, out=base[1:])
    lib = _lib()
    err = lib.sim_messages(
        sel.data_ptr(), pid.data_ptr(), sent.data_ptr(), base.data_ptr(),
        n_sel, indptr.data_ptr(), indices.data_ptr(), wgt.data_ptr(),
        owner.data_ptr(), n, key.data_ptr(), msg.data_ptr(),
        rabs.data_ptr(), n_e, stream_handle(dev))
    check(lib, err, "sim_messages")
    LAUNCHES["sim_messages"] += 1
    return key, msg, rabs


def sim_push(state: torch.Tensor, key: torch.Tensor,
             msg: torch.Tensor) -> None:
    """Add ``msg`` (float64 ``[E]``) into ``state`` (float64, contiguous)
    at ``key`` (int32 ``[E]``, as :func:`sim_messages` makes it), in
    message order for every key."""
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
    if e == 0:
        return
    key_sorted, order = torch.sort(key, stable=True)
    _launch_sim_push(key_sorted, order, msg, state)
    LAUNCHES["sim_push"] += 1


def _launch_sim_push(key_sorted: torch.Tensor, order: torch.Tensor,
                     msg: torch.Tensor, state: torch.Tensor) -> None:
    """K7's sum on ``key_sorted, order = torch.sort(key, stable=True)``,
    CUDA tensors as :func:`sim_push` checks them; counted nowhere."""
    lib = _lib()
    err = lib.sim_push(key_sorted.data_ptr(), order.data_ptr(),
                       msg.data_ptr(), state.data_ptr(), key_sorted.numel(),
                       stream_handle(state.device))
    check(lib, err, "sim_push")
