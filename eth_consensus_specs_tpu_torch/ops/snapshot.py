"""Durable resident state: digest-verified checkpoint and restore of the
incremental forest and the columns, and the salted scrub.

Counterpart of ``eth_consensus_specs_tpu/ops/snapshot.py``. The on-disk
format is the JAX package's byte for byte, so a checkpoint written by one
package restores in the other:

* blobs are the numpy bytes of each buffer (u64 and u32 values as
  ``uint64`` / ``uint32``, as ``convert.to_numpy`` views the port's int64 /
  int32 carriers), stored content-addressed under ``objects/<sha256>``;
* every blob and manifest write is write -> read back -> digest check ->
  ``os.replace``, retried up to three times on a torn write; the manifest
  (the same JSON keys, ``sort_keys``, ``plan`` as a list) commits after its
  blobs and the ``LATEST`` pointer last, so a crash mid-write leaves the
  previous checkpoint intact;
* a restore checks every digest and then refuses to serve unless the forest
  re-verifies: with ``verify="device"`` every tree's levels are rebuilt from
  its leaves (the forest kernel, every leaf dirty) and compared, and the state root recomputed from
  the forest must equal the manifest's; with ``verify="host"`` hashlib
  re-hashes the level chain instead.

``scrub_forest`` re-hashes K salted subtrees of every tree (the forest kernel, batched)
against the stored levels, plus the whole region above the subtree cut, in
fresh buffers that never alias the forest; ``quarantine_rebuild`` rebuilds a
tree's levels from its leaves in place (JAX donates the buffer).

The JAX package's fault-injection seams and its trace spans and counters
are not ported (the port has neither layer yet).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..convert import plan_from_numpy, tensor_from_numpy, to_numpy
from ..device import default_device
from ..lanes import to_i32
from . import merkle_inc
from .altair_epoch import AltairEpochColumns
from .state_columns import JustificationState
from .state_root import ForestPlan, StateForest, state_root_from_forest

MANIFEST_VERSION = 1
_OBJECTS = "objects"
_LATEST = "LATEST"
_TREES = ("val_nodes", "bal_nodes", "inact_nodes")
_WRITE_ATTEMPTS = 3
_RETRY_DELAY_S = 0.01
# subtree cut depth of one scrub check: 2^5 leaves re-hashed per sample
SCRUB_SUBTREE_DEPTH = 5


class SnapshotError(RuntimeError):
    """Checkpoint/restore integrity failure. ``degradable`` marks it as
    damage from the environment (torn write, bit rot), not a logic error:
    the caller may fall back to a full re-ingest."""

    degradable = True


class TornCheckpoint(SnapshotError):
    """A blob or manifest failed its digest check."""


class RestoreMismatch(SnapshotError):
    """The restored forest failed re-verification: rebuilt levels or the
    recomputed state root disagree with the manifest. The restore refuses
    to serve this state."""


# ------------------------------------------------------------- encoding --


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _host(a) -> np.ndarray:
    return to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _arr_bytes(a) -> bytes:
    return np.ascontiguousarray(_host(a)).tobytes()


def _arr_meta(a) -> dict:
    host = _host(a)
    return {"dtype": host.dtype.name, "shape": list(host.shape)}


def _decode(data: bytes, meta: dict) -> np.ndarray:
    return np.frombuffer(data, dtype=np.dtype(meta["dtype"])).reshape(tuple(meta["shape"]))


def _words_bytes(words) -> bytes:
    """u32[8] root words -> the canonical 32 big-endian bytes."""
    return np.asarray(_host(words), np.uint32).astype(">u4").tobytes()


def _host_combine(shard_roots: np.ndarray) -> bytes:
    """[S, 8] per-shard root words -> the tree root bytes, combined
    pairwise as ``merkle_inc.forest_root`` does."""
    level = [_words_bytes(shard_roots[i]) for i in range(shard_roots.shape[0])]
    while len(level) > 1:
        level = [hashlib.sha256(level[2 * i] + level[2 * i + 1]).digest()
                 for i in range(len(level) // 2)]
    return level[0]


def _level_layout(n_nodes: int) -> list[tuple[int, int]]:
    """(offset, width) of every level of a flat tree of ``n_nodes`` rows,
    leaves first, root last."""
    depth = merkle_inc.tree_depth(n_nodes)
    return [(merkle_inc.level_offset(depth, k), 1 << (depth - k)) for k in range(depth + 1)]


def _tree_level_digests(nodes: np.ndarray) -> list[str]:
    """Per-level digests over all shards of one forest tree."""
    return [_digest(_arr_bytes(nodes[:, off:off + width, :]))
            for off, width in _level_layout(nodes.shape[-2])]


# ----------------------------------------------------------- blob store --


def _objects_dir(root_dir: str) -> str:
    return os.path.join(root_dir, _OBJECTS)


def _write_verified(path: str, data: bytes, want: str) -> None:
    """One verified write: write, read back, digest check, atomic rename."""
    tmp = f"{path}.__tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    with open(tmp, "rb") as f:
        back = f.read()
    if _digest(back) != want:
        os.unlink(tmp)
        raise TornCheckpoint(f"write verify failed for {os.path.basename(path)}")
    os.replace(tmp, path)


def _write_retrying(path: str, data: bytes, want: str) -> None:
    """``_write_verified``, up to three attempts on a torn write or an
    ``OSError``, with a doubling pause between them."""
    for attempt in range(_WRITE_ATTEMPTS):
        try:
            _write_verified(path, data, want)
            return
        except (TornCheckpoint, OSError):
            if attempt + 1 == _WRITE_ATTEMPTS:
                raise
            time.sleep(_RETRY_DELAY_S * 2 ** attempt)


def _put_blob(root_dir: str, data: bytes, *, incremental: bool) -> tuple[str, bool]:
    """Store one content-addressed blob; returns (digest, written).
    Incremental mode trusts an existing blob of the same digest; full mode
    reads it back and rewrites it if damaged."""
    dig = _digest(data)
    final = os.path.join(_objects_dir(root_dir), dig)
    if os.path.exists(final):
        if incremental:
            return dig, False
        try:
            with open(final, "rb") as f:
                if _digest(f.read()) == dig:
                    return dig, False
        except OSError:
            pass  # unreadable: rewrite it
    _write_retrying(final, data, dig)
    return dig, True


def _get_blob(root_dir: str, dig: str) -> bytes:
    path = os.path.join(_objects_dir(root_dir), dig)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as exc:
        raise TornCheckpoint(f"missing checkpoint blob {dig[:12]}: {exc}") from exc
    if _digest(data) != dig:
        raise TornCheckpoint(f"checkpoint blob {dig[:12]} failed its digest check")
    return data


# ---------------------------------------------------------- checkpoints --


class CheckpointResult(NamedTuple):
    manifest: dict
    digest: str  # sha256 of the committed manifest file bytes
    path: str
    written: int  # blobs that hit disk
    reused: int  # blobs already present
    bytes_written: int  # bytes that hit disk: the blobs written and the manifest


def _checkpoint_tree(root_dir: str, nodes, *, incremental: bool):
    host = _host(nodes)
    shards, written, reused, nbytes = [], 0, 0, 0
    for i in range(host.shape[0]):
        data = _arr_bytes(host[i])
        dig, wrote = _put_blob(root_dir, data, incremental=incremental)
        shards.append(dig)
        written += int(wrote)
        reused += int(not wrote)
        nbytes += len(data) if wrote else 0
    entry = {
        **_arr_meta(host),
        "shards": shards,
        "levels": _tree_level_digests(host),
        "root": _host_combine(host[:, -1, :]).hex(),
    }
    return entry, written, reused, nbytes


def _checkpoint_fields(root_dir: str, tree, *, incremental: bool):
    out, written, reused, nbytes = {}, 0, 0, 0
    for name, val in tree._asdict().items():
        if val is None:
            out[name] = None
            continue
        data = _arr_bytes(val)
        dig, wrote = _put_blob(root_dir, data, incremental=incremental)
        out[name] = {**_arr_meta(val), "blob": dig}
        written += int(wrote)
        reused += int(not wrote)
        nbytes += len(data) if wrote else 0
    return out, written, reused, nbytes


def checkpoint(root_dir: str, forest: StateForest, cols, just, *, epoch: int, plan: ForestPlan,
               static=None, state_root: bytes | None = None, epoch0: int = 0,
               incremental: bool = True, extra: dict | None = None) -> CheckpointResult:
    """Commit one durable checkpoint of the resident state, outside the
    epoch loop (the forest and columns are fetched to the host). With
    ``static`` and no ``state_root``, the manifest's root is recomputed
    from the forest (``state_root_from_forest``). ``extra`` is an optional
    JSON-serialisable payload inside the digest-covered content. Blobs
    commit before the manifest, the manifest before ``LATEST``."""
    os.makedirs(_objects_dir(root_dir), exist_ok=True)
    if state_root is None and static is not None:
        state_root = state_root_bytes(static, plan, forest, just)

    written = reused = nbytes = 0
    trees: dict[str, dict | None] = {}
    for name in _TREES:
        nodes = getattr(forest, name)
        if nodes is None:
            trees[name] = None
            continue
        trees[name], w, r, b = _checkpoint_tree(root_dir, nodes, incremental=incremental)
        written, reused, nbytes = written + w, reused + r, nbytes + b
    part = _arr_bytes(forest.part_root)
    part_dig, wrote = _put_blob(root_dir, part, incremental=incremental)
    written, reused, nbytes = written + int(wrote), reused + int(not wrote), nbytes + (
        len(part) if wrote else 0)
    trees["part_root"] = {**_arr_meta(forest.part_root), "blob": part_dig}

    cols_entry, w, r, b = _checkpoint_fields(root_dir, cols, incremental=incremental)
    written, reused, nbytes = written + w, reused + r, nbytes + b
    just_entry, w, r, b = _checkpoint_fields(root_dir, just, incremental=incremental)
    written, reused, nbytes = written + w, reused + r, nbytes + b

    content = {
        "epoch": int(epoch),
        "state_root": state_root.hex() if state_root else None,
        "trees": trees,
        "columns": {"cols": cols_entry, "just": just_entry},
    }
    if extra is not None:
        content["extra"] = extra
    parent = None
    try:
        prev = latest(root_dir)
        if prev is not None:
            parent = prev[1]
    except TornCheckpoint:
        parent = None  # a torn predecessor never blocks a new checkpoint
    manifest = {
        "version": MANIFEST_VERSION,
        **content,
        "content_digest": _digest(json.dumps(content, sort_keys=True).encode()),
        "epoch_span": [int(epoch0), int(epoch)],
        "parent": parent,
        "incremental": bool(incremental),
        "plan": list(plan),
        "counts": {"written": written, "reused": reused},
    }
    data = json.dumps(manifest, sort_keys=True).encode()
    dig = _digest(data)
    name = f"manifest-{int(epoch):08d}.json"
    path = os.path.join(root_dir, name)
    _write_retrying(path, data, dig)
    pointer = json.dumps({"manifest": name, "digest": dig}).encode()
    tmp = os.path.join(root_dir, f"{_LATEST}.__tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(pointer)
    os.replace(tmp, os.path.join(root_dir, _LATEST))
    return CheckpointResult(manifest=manifest, digest=dig, path=path, written=written,
                            reused=reused, bytes_written=nbytes + len(data))


def latest(root_dir: str) -> tuple[dict, str] | None:
    """(manifest, manifest digest) of the committed ``LATEST`` checkpoint,
    or None when the store has none. Raises ``TornCheckpoint`` when the
    pointer names a manifest that is missing or fails its digest."""
    try:
        with open(os.path.join(root_dir, _LATEST), "rb") as f:
            pointer = json.loads(f.read())
    except (OSError, ValueError):
        return None
    name, want = pointer.get("manifest", ""), pointer.get("digest", "")
    try:
        with open(os.path.join(root_dir, name), "rb") as f:
            data = f.read()
    except OSError as exc:
        raise TornCheckpoint(f"LATEST points at missing manifest {name}") from exc
    if _digest(data) != want:
        raise TornCheckpoint(f"manifest {name} failed its digest check")
    return json.loads(data), want


# -------------------------------------------------------------- restore --


class RestoredState(NamedTuple):
    forest: StateForest
    cols: AltairEpochColumns
    just: JustificationState
    plan: ForestPlan
    manifest: dict
    digest: str
    epoch: int
    verdict: str  # "verified-device" | "verified-host"


def state_root_bytes(static, plan: ForestPlan, forest: StateForest, just) -> bytes:
    """The state root of a resident forest as 32 bytes, computed on the
    forest's device (``state_root_from_forest``)."""
    arrays, meta = static
    dev = forest.val_nodes.device
    arrays = type(arrays)(*(t.to(dev) for t in arrays))
    just = type(just)(*(t.to(dev) for t in just))
    return _words_bytes(state_root_from_forest(arrays, meta, plan, forest, just))


def _restore_tree(root_dir: str, entry: dict) -> np.ndarray:
    meta = {**entry, "shape": entry["shape"][1:]}
    return np.stack([_decode(_get_blob(root_dir, dig), meta) for dig in entry["shards"]])


def _restore_fields(root_dir: str, entry: dict, cls, dev):
    return cls(**{
        name: None if meta is None else tensor_from_numpy(
            _decode(_get_blob(root_dir, meta["blob"]), meta), dev)
        for name, meta in entry.items()
    })


def _host_verify_tree(name: str, host: np.ndarray, entry: dict) -> None:
    """hashlib re-hash of one restored tree: the level digests pin the
    bytes to the manifest's, then every internal node is recomputed from
    the level below and compared."""
    layout = _level_layout(host.shape[-2])
    for k, dig in enumerate(entry["levels"]):
        off, width = layout[k]
        if _digest(_arr_bytes(host[:, off:off + width, :])) != dig:
            raise RestoreMismatch(f"{name}: level {k} digest mismatch after restore")
    be = host.astype(">u4")
    for k in range(len(layout) - 1):
        off, width = layout[k]
        p_off, p_width = layout[k + 1]
        child = be[:, off:off + width, :].reshape(host.shape[0], width // 2, 16)
        for s in range(host.shape[0]):
            for j in range(p_width):
                if hashlib.sha256(child[s, j].tobytes()).digest() != be[s, p_off + j].tobytes():
                    raise RestoreMismatch(f"{name}: rebuilt node ({s}, level {k + 1}, {j}) "
                                          "disagrees with the restored buffer")


def _levels_exact(nodes: torch.Tensor) -> bool:
    """Every internal level rebuilt from the leaf rows (the forest kernel, into a fresh
    buffer) equals the stored one."""
    leaves = (nodes.shape[-2] + 1) // 2
    return bool(torch.equal(merkle_inc.build_levels(nodes[:, :leaves]), nodes))


def restore(root_dir: str, *, static=None, verify: str = "device",
            device=None) -> RestoredState | None:
    """The resident state of the ``LATEST`` checkpoint on ``device`` (the
    CUDA card unless the caller names another), refusing to serve it
    unless it re-verifies. ``verify="device"``: every tree's levels are
    rebuilt on the device from the restored leaves and compared, and, with
    ``static``, the state root recomputed from the forest must equal the
    manifest's. ``verify="host"``: hashlib re-hashes the level chain.
    Returns None when the store holds no checkpoint; raises
    ``TornCheckpoint`` / ``RestoreMismatch`` on damage."""
    if verify not in ("device", "host"):
        raise ValueError(f"verify must be 'device' or 'host', got {verify!r}")
    dev = default_device(device)
    found = latest(root_dir)
    if found is None:
        return None
    manifest, dig = found
    plan = plan_from_numpy(manifest["plan"])
    if plan.shards != 1:
        raise NotImplementedError("restoring a sharded forest is not ported yet")
    trees = {}
    for name in _TREES:
        entry = manifest["trees"][name]
        if entry is None:
            trees[name] = None
            continue
        host = _restore_tree(root_dir, entry)
        if verify == "host":
            _host_verify_tree(name, host, entry)
        if _host_combine(host[:, -1, :]).hex() != entry["root"]:
            raise RestoreMismatch(f"{name}: restored root disagrees with manifest")
        trees[name] = tensor_from_numpy(host, dev)
    part_entry = manifest["trees"]["part_root"]
    part_root = _decode(_get_blob(root_dir, part_entry["blob"]), part_entry)
    forest = StateForest(part_root=tensor_from_numpy(part_root, dev), **trees)
    cols = _restore_fields(root_dir, manifest["columns"]["cols"], AltairEpochColumns, dev)
    just = _restore_fields(root_dir, manifest["columns"]["just"], JustificationState, dev)
    if verify == "device":
        for name in _TREES:
            nodes = getattr(forest, name)
            if nodes is not None and not _levels_exact(nodes):
                raise RestoreMismatch(f"{name}: rebuilt levels disagree with the restored buffers")
        if static is not None and manifest["state_root"]:
            if state_root_bytes(static, plan, forest, just).hex() != manifest["state_root"]:
                raise RestoreMismatch("recomputed state root disagrees with the manifest; "
                                      "refusing to serve this checkpoint")
    return RestoredState(forest=forest, cols=cols, just=just, plan=plan, manifest=manifest,
                         digest=dig, epoch=int(manifest["epoch"]), verdict=f"verified-{verify}")


# ---------------------------------------------------------------- scrub --


class ScrubReport(NamedTuple):
    checks: int
    mismatches: int
    # tree name -> subtree positions (shard * per_shard + pos) that failed
    # their re-hash, or -1 for an upper-region mismatch
    bad: dict[str, list[int]]
    root: bytes  # the val-tree root observed during the pass


def _scrub_tree(nodes: torch.Tensor, sub_depth: int, sidx, pos):
    """Re-hash K subtrees of 2^sub_depth leaves of one forest tree (their
    shard indices ``sidx`` and positions ``pos``) and compare every level of
    each with the stored rows; rebuild the whole region above the subtree
    cut and compare it. Both rebuilds (the forest kernel, the subtrees batched) go into
    fresh buffers. Returns (bool[K] subtree mismatches, upper mismatch)."""
    m = nodes.shape[-2]
    dl = merkle_inc.tree_depth(m)
    w = 1 << sub_depth
    dev = nodes.device
    flat = nodes.reshape(-1, 8)
    sidx = torch.tensor(sidx, dtype=torch.int64, device=dev)
    pos = torch.tensor(pos, dtype=torch.int64, device=dev)
    base = sidx * m
    leaf_rows = (base + pos * w)[:, None] + torch.arange(w, device=dev)
    rebuilt = merkle_inc.build_levels(flat[leaf_rows.reshape(-1)].reshape(-1, w, 8))
    stored_rows = torch.cat([
        (base + merkle_inc.level_offset(dl, j) + pos * (w >> j))[:, None]
        + torch.arange(w >> j, device=dev)
        for j in range(sub_depth + 1)
    ], dim=1)
    stored = flat[stored_rows.reshape(-1)].reshape(rebuilt.shape)
    low_bad = (rebuilt != stored).flatten(1).any(dim=1)
    off_sd = merkle_inc.level_offset(dl, sub_depth)
    upper = merkle_inc.build_levels(nodes[:, off_sd:off_sd + (1 << (dl - sub_depth))])
    return low_bad, bool((upper != nodes[:, off_sd:]).any())


def _salted_positions(salt: int, tree: str, k: int, total: int) -> list[int]:
    """K deterministic pseudo-random subtree positions for this (salt,
    tree), derived with sha256 so a re-run scrubs the same subtrees."""
    out = []
    for i in range(k):
        h = hashlib.sha256(f"scrub:{salt}:{tree}:{i}".encode()).digest()
        out.append(int.from_bytes(h[:8], "big") % total)
    return out


def scrub_forest(forest: StateForest, *, k: int = 8, salt: int = 0,
                 expect_root: bytes | None = None,
                 sub_depth: int = SCRUB_SUBTREE_DEPTH) -> ScrubReport:
    """One scrub pass over every tree of a resident forest: K salted
    subtrees per tree re-hashed and compared with the stored levels, and
    the region above the subtree cut every pass. ``expect_root`` also
    compares the observed val-tree root with the last known-good one. A
    mismatch is silent memory corruption: the caller quarantines the tree
    (:func:`quarantine_rebuild`) and re-verifies the root."""
    checks = mismatches = 0
    bad: dict[str, list[int]] = {}
    root = b""
    for name in _TREES:
        nodes = getattr(forest, name)
        if nodes is None:
            continue
        s, m = nodes.shape[0], nodes.shape[-2]
        dl = merkle_inc.tree_depth(m)
        sd = min(sub_depth, dl)
        per_shard = 1 << (dl - sd)
        total = s * per_shard
        kk = min(k, total)
        positions = _salted_positions(salt, name, kk, total)
        low_bad, upper_bad = _scrub_tree(nodes, sd, [p // per_shard for p in positions],
                                         [p % per_shard for p in positions])
        checks += kk + 1  # +1: the upper-region sweep
        tree_bad = [p for p, b in zip(positions, low_bad.tolist()) if b]
        if upper_bad:
            tree_bad.append(-1)
        if tree_bad:
            bad[name] = tree_bad
            mismatches += len(tree_bad)
        if name == "val_nodes":
            root = _words_bytes(merkle_inc.forest_root(nodes))
    if expect_root is not None and root and root != expect_root:
        mismatches += 1
        bad.setdefault("val_nodes", []).append(-1)
    return ScrubReport(checks=checks, mismatches=mismatches, bad=bad, root=root)


def quarantine_rebuild(forest: StateForest, tree: str) -> StateForest:
    """Recompute every internal level of one tree from its resident leaves,
    in place (the forest kernel). A corrupted internal node heals; a corrupted leaf
    gives a consistent but wrong tree, which the caller's root check
    catches."""
    nodes = getattr(forest, tree)
    if nodes is not None:
        merkle_inc.merkle_levels(nodes)
    return forest


def flip_resident_word(forest: StateForest, tree: str, node: int, word: int = 0) -> StateForest:
    """A copy of ``forest`` with one u32 word of a tree flipped (the silent
    memory corruption the scrub must catch); the original is untouched."""
    flipped = getattr(forest, tree).clone()
    flipped[0, node, word] ^= int(to_i32(torch.tensor(0xDEADBEEF)))
    return forest._replace(**{tree: flipped})
