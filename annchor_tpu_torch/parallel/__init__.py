"""The device mesh of the multi-device fit: one process, a tuple of devices.

Port of the JAX package's ``parallel`` module.  There, one program runs
SPMD over a mesh of chips with ``jax.shard_map``.  Here a mesh is a
tuple of ``torch.device``s driven from one Python process, and a
sharded stage is a loop over the shards that runs the single-device
function on each shard's slice, on that shard's device.  The
collectives of the JAX programs become explicit copies and reductions
over lists of per-shard tensors (``all_gather``, ``psum``, ``pmax``,
``pmin``, ``broadcast``).  As in the JAX package no process group is
needed: the work is a data-parallel map over the candidate-pair axis,
and one ``Annchor(...).fit()`` call drives every device.

A mesh may name one device several times.  Shards of one device share
its replicated tensors (a collective copies once per distinct device)
and run one after another on that device's current stream, so a mesh of
four shards on one card runs every sharded code path and its kernel
launches there, and the same code spans four cards unchanged.  Copies
between cards are asynchronous; PyTorch orders them on both devices'
streams, so no stage waits for the host.

``auto_mesh(device)`` reads the JAX package's two variables:

* ``ANNCHOR_TPU_DISABLE_SHARDING``: no mesh;
* ``ANNCHOR_TPU_MESH_DEVICES=n``: an n-shard mesh over the fit's device
  type, the devices repeated round-robin where n exceeds the visible
  cards or the device is the CPU.  This is the port's counterpart of
  XLA's ``--xla_force_host_platform_device_count``, which gives the JAX
  package's tests 8 virtual CPU devices.

With neither set, the mesh spans every visible card when there are two
or more, and there is none otherwise (the single-device fit).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from annchor_tpu_torch._backend import shard_scope

PAIR_AXIS = "pairs"

__all__ = [
    "PAIR_AXIS",
    "Mesh",
    "all_gather",
    "auto_mesh",
    "available_devices",
    "broadcast",
    "dryrun_multichip",
    "gather_to",
    "mesh_for",
    "pad_to_multiple",
    "pair_sharded",
    "pmax",
    "pmin",
    "psum",
    "sharded_pair_kernel",
    "split_pairs",
    "to_device",
]


def _canonical(device) -> torch.device:
    """A device with its index spelled out (``cuda`` -> ``cuda:k``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A 1-d mesh over the ``pairs`` axis: shard c runs on
    ``devices[c]`` (a device may repeat)."""

    axis_names = (PAIR_AXIS,)

    def __init__(self, devices):
        devs = tuple(_canonical(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __repr__(self):
        return "Mesh(%s)" % ", ".join(str(d) for d in self.devices)


def available_devices(prefer: str | None = None):
    """Devices for mesh construction: every visible card, or the CPU
    with ``prefer="cpu"`` or when there is no card."""
    kind = prefer or ("cuda" if torch.cuda.is_available() else "cpu")
    if kind == "cuda":
        return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError("no devices of type %r" % kind)


def _round_robin(devices, n: int):
    return [devices[k % len(devices)] for k in range(n)]


def mesh_for(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards over ``devices`` (default: every
    visible card, else the CPU), repeating the devices round-robin when
    there are fewer of them than shards."""
    devices = list(available_devices() if devices is None else devices)
    if n_devices is not None:
        devices = _round_robin(devices, int(n_devices))
    return Mesh(devices)


def auto_mesh(device="cuda") -> Mesh | None:
    """The mesh a fit on ``device`` shards over, or None for the
    single-device fit (see the module's docstring for the variables).
    The mesh's first device is ``device``; on a card, the others follow
    it in index order."""
    if os.environ.get("ANNCHOR_TPU_DISABLE_SHARDING"):
        return None
    dev = _canonical(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        visible = [torch.device("cuda", (dev.index + k) % count) for k in range(count)]
    else:
        visible = [dev]
    limit = int(os.environ.get("ANNCHOR_TPU_MESH_DEVICES", "0") or 0)
    devices = _round_robin(visible, limit) if limit > 0 else visible
    if len(devices) < 2:
        return None
    return Mesh(devices)


def pad_to_multiple(arrays, multiple: int, axis: int = 0):
    """Pad each array's leading axis to a multiple (edge-replicated, so
    padded lanes compute valid, discardable work).  Returns (padded, n)."""
    n = arrays[0].shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return list(arrays), n
    out = []
    for a in arrays:
        pad_width = [(0, 0)] * a.ndim
        pad_width[axis] = (0, rem)
        out.append(np.pad(np.asarray(a), pad_width, mode="edge"))
    return out, n


# ---------------------------------------------------------------------------
# collectives over lists of per-shard tensors


def to_device(t, device):
    """``t`` on ``device``; no copy when it is there already.  A copy to
    a card does not wait for the host; one to the CPU does."""
    if t.device == device:
        return t
    return t.to(device, non_blocking=device.type == "cuda")


def broadcast(t, devices):
    """``t`` on every device of ``devices``, one copy per distinct
    device: shards of one device share it."""
    copies = {}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = to_device(t, d)
        out.append(copies[d])
    return out


def gather_to(parts, device):
    """The concatenation of the per-shard tensors ``parts`` on one
    device."""
    if len(parts) == 1:
        return to_device(parts[0], device)
    return torch.cat([to_device(p, device) for p in parts])


def all_gather(parts, devices=None):
    """Tiled all-gather: the concatenation of ``parts`` on every
    shard's device (default: each part's own device)."""
    devices = [p.device for p in parts] if devices is None else list(devices)
    return broadcast(gather_to(parts, devices[0]), devices)


def _reduce(op, parts, devices):
    devices = [p.device for p in parts] if devices is None else list(devices)
    acc = to_device(parts[0], devices[0])
    for p in parts[1:]:
        acc = op(acc, to_device(p, devices[0]))
    return broadcast(acc, devices)


def psum(parts, devices=None):
    """Elementwise sum of the per-shard tensors, on every shard's
    device.  Exact for integers; for floats only where each entry has
    one nonzero owner."""
    return _reduce(torch.add, parts, devices)


def pmax(parts, devices=None):
    """Elementwise maximum of the per-shard tensors, on every shard's
    device (exact: max is order-free)."""
    return _reduce(torch.maximum, parts, devices)


def pmin(parts, devices=None):
    """Elementwise minimum of the per-shard tensors, on every shard's
    device (exact: min is order-free)."""
    return _reduce(torch.minimum, parts, devices)


# ---------------------------------------------------------------------------
# pair kernels split over the mesh


def pair_sharded(fn, mesh: Mesh, n_replicated: int):
    """``fn`` split over the ``pairs`` axis of ``mesh``.

    fn(*replicated, *per_pair) -> per-pair tensor (or a tuple of them).
    The first ``n_replicated`` arguments are copied to every shard's
    device; the rest are split on their leading axis, which must be a
    multiple of the mesh size, and shard c's slice runs on
    ``mesh.devices[c]`` (its kernel launches count toward shard c).  The
    shards' results are concatenated in shard order on the mesh's first
    device."""

    @functools.wraps(fn)
    def wrapped(*args):
        s = mesh.size
        repl = [broadcast(a, mesh.devices) for a in args[:n_replicated]]
        split = []
        for a in args[n_replicated:]:
            if a.shape[0] % s:
                raise ValueError(
                    "per-pair axis of length %d is not a multiple of the mesh size %d"
                    % (a.shape[0], s)
                )
            split.append(a.tensor_split(s))
        outs = []
        for c, dev in enumerate(mesh.devices):
            with shard_scope(c):
                outs.append(
                    fn(*(r[c] for r in repl), *(to_device(p[c], dev) for p in split))
                )
        first = mesh.devices[0]
        if isinstance(outs[0], tuple):
            return tuple(gather_to(list(o), first) for o in zip(*outs))
        return gather_to(outs, first)

    return wrapped


def sharded_pair_kernel(kern, mesh: Mesh, n_replicated: int):
    """``pair_sharded`` taking host arrays or tensors: the per-pair
    operands must already be padded to a multiple of the mesh size (see
    ``pad_to_multiple``)."""
    mapped = pair_sharded(kern, mesh, n_replicated)

    def run(*args):
        return mapped(*(torch.as_tensor(a) for a in args))

    return run


def split_pairs(fn, mesh: Mesh, I, J):
    """fn(I_c, J_c) -> per-pair tensor on each shard's slice of the pair
    ids I, J (tensors), padded by repeating the last pair to a multiple
    of the mesh size; the result in pair order on I's device."""
    B = int(I.shape[0])
    if B == 0:
        return fn(I, J)
    rem = (-B) % mesh.size
    if rem:
        I = torch.cat([I, I[-1:].expand(rem)])
        J = torch.cat([J, J[-1:].expand(rem)])
    out = pair_sharded(fn, mesh, 0)(I, J)
    return to_device(out[:B], I.device)


# ---------------------------------------------------------------------------
# the dry run


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the real fit sharded over an ``n_devices``-shard mesh on
    ``device`` and hold it to the single-device fit: 240 strings on the
    scale path (``ANNCHOR_TPU_FORCE_SPARSE``) at an explicit pair cap of
    64, so the two fits track the same pair set (the derived cap scales
    with the mesh).  The sharded fit state must hold ``m_pad / n`` pairs
    and ``nx_pad / n`` incidence rows on each shard, and the graphs must
    be equal bit for bit.  The JAX package's ``__graft_entry__`` runs the
    same check; its second part, a toy step on a 2-d mesh that no fit
    path uses, has no counterpart here."""
    import annchor_tpu_torch as att
    from annchor_tpu_torch.datasets import make_strings

    X, _ = make_strings(n=240, length=48, seed=3)
    kw = dict(
        func="levenshtein", n_anchors=10, n_neighbors=8,
        n_samples=600, p_work=0.3, random_seed=42, device=device,
    )
    keys = ("ANNCHOR_TPU_FORCE_SPARSE", "ANNCHOR_TPU_MESH_DEVICES",
            "ANNCHOR_TPU_PAIR_CAP", "ANNCHOR_TPU_DISABLE_SHARDING")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(ANNCHOR_TPU_FORCE_SPARSE="1", ANNCHOR_TPU_PAIR_CAP="64",
                      ANNCHOR_TPU_MESH_DEVICES=str(int(n_devices)))
    try:
        os.environ["ANNCHOR_TPU_DISABLE_SHARDING"] = "1"
        ref = att.Annchor(list(X), **kw)
        ref.fit()
        del os.environ["ANNCHOR_TPU_DISABLE_SHARDING"]
        ann = att.Annchor(list(X), **kw)
        ann.fit()
        dev = ann._dev
        if dev.shard is None or dev.shard.s != n_devices:
            raise AssertionError("fit state not sharded over %d shards" % n_devices)
        if [t.shape[0] for t in dev.RA] != [dev.m_pad // n_devices] * n_devices:
            raise AssertionError("pair state not distributed over the mesh")
        if [t.shape[0] for t in dev.P_idx_d] != [dev.shard.nx_pad // n_devices] * n_devices:
            raise AssertionError("incidence matrix not distributed over the mesh")
        if not np.array_equal(ref.neighbor_graph[0], ann.neighbor_graph[0]):
            raise AssertionError("sharded fit diverged from the single-device fit (indices)")
        if not np.array_equal(ref.neighbor_graph[1], ann.neighbor_graph[1]):
            raise AssertionError("sharded fit diverged from the single-device fit (distances)")
        if ann.evals != ref.evals:
            raise AssertionError("sharded fit spent %d evals, the single-device fit %d"
                                 % (ann.evals, ref.evals))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
