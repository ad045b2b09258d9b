"""FB+-tree core structure for the port (counterpart of ``repro.core.fbtree``).

The same pointer-free structure-of-arrays layout as the reference
(DESIGN.md §1), held in torch tensors on one device:

* inner level ``l`` (level 0 = root, fixed height — upper levels may be
  single-child chains): ``knum``, ``plen``, ``prefix``, ``features``
  (``uint8[fs, ns]`` per node, transposed so one row is one anchor vector),
  ``children`` and ``anchors`` (key ids into the key pool);
* leaves: unsorted kv slots + occupancy + 1-byte hashtags + high key +
  sibling link + version word.

Every field name, dtype and shape equals the reference's, including the
trailing scratch row of every array. This module holds both builds of the
reference: the host numpy build (:func:`bulk_build`), which runs on the
host and moves each array to the target device once, and the device build
(:func:`_device_build_from_sorted`, ``bulk_build(device=True)``), which
sorts and builds on the target device and which ``batch_ops.rebuild``
reruns over a tree's live keys. It also holds :func:`sharded_partition`,
the range split a sharded build starts from.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import keys as K

__all__ = ["TreeConfig", "Level", "TreeArrays", "FBTree", "EMPTY", "BIG",
           "bulk_build", "stack_levels", "chunk_start", "chunk_of_pos",
           "recompute_inner_meta", "resolve_target", "sharded_partition"]

EMPTY = -1
BIG = 2**30


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Static tree geometry (hashable); the fields mean what they mean in
    ``repro.core.fbtree.TreeConfig``. Every tensor in :class:`TreeArrays`
    has a shape fully determined by this config."""
    key_width: int
    ns: int = 64           # slots / anchors per node (paper default 64)
    fs: int = 4            # feature bytes per anchor (paper default 4)
    leaf_fill: int = 48    # bulk-load / repack target occupancy
    inner_fill: int = 48
    n_levels: int = 3      # inner levels incl. root chain
    leaf_cap: int = 1024
    level_caps: Tuple[int, ...] = (1, 16, 256)
    key_cap: int = 65536
    val_dtype: Any = torch.int32
    # default descent layout for the traversal engine: False = per-level
    # tuple, True = stacked [n_levels, C_max, ...] tensors. Both layouts are
    # always materialized.
    stacked: bool = False

    def __post_init__(self):
        def bad(msg: str):
            raise ValueError(f"TreeConfig: {msg}")
        if self.key_width < 1:
            bad(f"key_width must be >= 1, got {self.key_width} (bytes per "
                f"fixed-width key-pool row)")
        if self.ns < 2:
            bad(f"ns must be >= 2, got {self.ns} — a node needs at least "
                f"two slots to ever split")
        if self.fs < 1:
            bad(f"fs must be >= 1, got {self.fs} (feature bytes per "
                f"anchor)")
        if not (1 <= self.leaf_fill <= self.ns):
            bad(f"leaf_fill must be in [1, ns={self.ns}], got "
                f"{self.leaf_fill} — TreeConfig.plan clamps it for you")
        if not (1 <= self.inner_fill <= self.ns):
            bad(f"inner_fill must be in [1, ns={self.ns}], got "
                f"{self.inner_fill} — TreeConfig.plan clamps it for you")
        if self.n_levels < 1:
            bad(f"n_levels must be >= 1, got {self.n_levels}")
        if len(self.level_caps) != self.n_levels:
            bad(f"level_caps has {len(self.level_caps)} entries for "
                f"n_levels={self.n_levels} — one cap per inner level, "
                f"root first (TreeConfig.plan derives them)")
        if any(c < 1 for c in self.level_caps):
            bad(f"level_caps must all be >= 1, got {self.level_caps}")
        if self.leaf_cap < 1:
            bad(f"leaf_cap must be >= 1, got {self.leaf_cap}")
        if self.key_cap < 1:
            bad(f"key_cap must be >= 1, got {self.key_cap}")

    @staticmethod
    def plan(max_keys: int, key_width: int, ns: int = 64, fs: int = 4,
             leaf_fill: int = 48, inner_fill: int = 48,
             val_dtype: Any = torch.int32, stacked: bool = False) -> "TreeConfig":
        """Capacity planning: fixed height with min-fanout-16 safety margin
        (``leaf_cap = ceil(max_keys / max(8, leaf_fill // 3))``, each inner
        level cap ``ceil(child_cap / 16)`` up to a single-node root)."""
        leaf_cap = max(2, -(-max_keys // max(8, leaf_fill // 3)))
        caps: List[int] = []
        c = leaf_cap
        while True:
            c = max(1, -(-c // 16))
            caps.append(c)
            if c == 1:
                break
        caps = caps[::-1]  # root first
        return TreeConfig(key_width=key_width, ns=ns, fs=fs,
                          leaf_fill=min(leaf_fill, ns), inner_fill=min(inner_fill, ns),
                          n_levels=len(caps), leaf_cap=leaf_cap,
                          level_caps=tuple(caps), key_cap=int(max_keys),
                          val_dtype=val_dtype, stacked=stacked)


class Level(NamedTuple):
    """One inner level, ``C = level_caps[l] + 1`` rows (last row = scratch).

    In the stacked layout (:func:`stack_levels`) the same six tensors gain
    a leading ``n_levels`` axis and ``count`` becomes ``int32[n_levels]``.
    """
    knum: torch.Tensor      # int32 [C]
    plen: torch.Tensor      # int32 [C]
    prefix: torch.Tensor    # uint8 [C, L]
    features: torch.Tensor  # uint8 [C, fs, ns]
    children: torch.Tensor  # int32 [C, ns]
    anchors: torch.Tensor   # int32 [C, ns]  (key ids)
    count: torch.Tensor     # int32 scalar — allocation watermark


class TreeArrays(NamedTuple):
    """All tree state; ``KC = key_cap + 1``, ``LC = leaf_cap + 1``."""
    key_bytes: torch.Tensor   # uint8 [KC, L]
    key_lens: torch.Tensor    # int32 [KC]
    key_tags: torch.Tensor    # uint8 [KC]
    key_count: torch.Tensor   # int32 scalar
    levels: Tuple[Level, ...]
    stacked: Level            # same levels, stacked+padded to [n_levels, C_max, ...]
    leaf_tags: torch.Tensor   # uint8 [LC, ns]
    leaf_keyid: torch.Tensor  # int32 [LC, ns] (-1 empty)
    leaf_val: torch.Tensor    # val_dtype [LC, ns]
    leaf_occ: torch.Tensor    # bool [LC, ns]
    leaf_high: torch.Tensor   # int32 [LC] key id, -1 = +inf
    leaf_next: torch.Tensor   # int32 [LC]
    leaf_version: torch.Tensor  # int32 [LC]
    leaf_ordered: torch.Tensor  # bool [LC]
    leaf_count: torch.Tensor    # int32 scalar


class FBTree:
    """A config plus its arrays; every op runs on the device the arrays
    live on (:attr:`device`)."""

    def __init__(self, config: TreeConfig, arrays: TreeArrays):
        self.config = config
        self.arrays = arrays

    def __getattr__(self, name):
        if name in TreeArrays._fields:
            return getattr(self.arrays, name)
        raise AttributeError(name)

    def replace(self, **kw) -> "FBTree":
        return FBTree(self.config, self.arrays._replace(**kw))

    @property
    def device(self) -> torch.device:
        return self.arrays.key_bytes.device

    @property
    def n_keys_live(self) -> int:
        return int(self.arrays.leaf_occ.sum())


def resolve_target(target: Optional[str]) -> torch.device:
    """The device an entry point builds on: ``None`` means the card, and
    raises when there is none; ``"cpu"`` must be asked for."""
    dev = torch.device("cuda" if target is None else target)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass target='cpu' to run on the "
            "CPU")
    return dev


def stack_levels(levels: Tuple[Level, ...]) -> Level:
    """Stack per-level tensors into one padded [n_levels, C_max, ...] Level.

    Rows past a level's own cap are knum=0 / children=anchors=EMPTY, so a
    backend treats them as trivial nodes. ``count`` becomes an int32
    [n_levels] vector.
    """
    C_max = max(l.knum.shape[0] for l in levels)

    def pad(a, fillv):
        short = C_max - a.shape[0]
        if short == 0:
            return a
        return torch.cat(
            [a, torch.full((short,) + tuple(a.shape[1:]), fillv,
                           dtype=a.dtype, device=a.device)], dim=0)

    return Level(
        knum=torch.stack([pad(l.knum, 0) for l in levels]),
        plen=torch.stack([pad(l.plen, 0) for l in levels]),
        prefix=torch.stack([pad(l.prefix, 0) for l in levels]),
        features=torch.stack([pad(l.features, 0) for l in levels]),
        children=torch.stack([pad(l.children, EMPTY) for l in levels]),
        anchors=torch.stack([pad(l.anchors, EMPTY) for l in levels]),
        count=torch.stack([l.count for l in levels]),
    )


# --------------------------------------------------------------------------
# shared segmented-construction primitives (DESIGN.md §5)
# --------------------------------------------------------------------------

def chunk_of_pos(p, base, rem):
    """Chunk index of position ``p`` under balanced chunking: ``n`` items
    over ``c`` chunks with ``base = n // c``, ``rem = n % c``; the first
    ``rem`` chunks hold ``base + 1`` items, the rest ``base``."""
    p, base, rem = (torch.as_tensor(x) for x in (p, base, rem))
    cut = (base + 1) * rem
    return torch.where(p < cut,
                       torch.div(p, torch.clamp(base + 1, min=1),
                                 rounding_mode="floor"),
                       rem + torch.div(p - cut, torch.clamp(base, min=1),
                                       rounding_mode="floor")
                       ).to(torch.int32)


def chunk_start(c, base, rem):
    """First item position of chunk ``c`` (inverse of :func:`chunk_of_pos`)."""
    c, base, rem = (torch.as_tensor(x) for x in (c, base, rem))
    return torch.where(c <= rem, c * (base + 1),
                       rem * (base + 1) + (c - rem) * base).to(torch.int32)


def recompute_inner_meta(kb_store: torch.Tensor, kl_store: torch.Tensor,
                         anchors: torch.Tensor, knum: torch.Tensor, fs: int,
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segmented reduction deriving ``plen``/``prefix``/``features`` for a
    block of inner nodes from their anchor key ids (the torch twin of the
    reference's ``recompute_inner_meta``). ``anchors`` is ``[R, ns]`` with
    ``EMPTY`` pads; invalid lanes contribute the identity.

    The common-prefix length is the first byte column where some valid
    anchor differs from anchor 0 (``torch.argmin`` returns the first
    minimum, as ``jnp.argmin`` does), clipped by the shortest anchor length
    and the key width; feature row ``f`` is byte ``plen + f`` of every
    anchor (0 past the key width). The insert split path runs it, so
    split-produced nodes agree with built ones byte for byte. Returns
    ``(plen int32 [R], prefix uint8 [R, L], features uint8 [R, fs, ns])``.
    """
    R, ns = anchors.shape
    L = kb_store.shape[-1]
    aid = torch.clamp(anchors, min=0).long()
    akb = kb_store[aid]                       # [R, ns, L]
    akl = kl_store[aid]
    lane = torch.arange(ns, dtype=torch.int32, device=anchors.device)[None, :]
    valid = lane < knum[:, None]
    same = (akb == akb[:, :1, :]) | ~valid[:, :, None]
    allsame = same.all(dim=1)                 # [R, L]
    plen = torch.where(allsame.all(-1), L,
                       torch.argmin(allsame.to(torch.int32), dim=-1))
    minlen = torch.where(valid, akl, BIG).amin(-1)
    plen = torch.minimum(plen, torch.clamp(minlen, max=L)).to(torch.int32)
    prefix = akb[:, 0, :]
    feats = []
    for f in range(fs):
        pos = torch.clamp(plen + f, 0, L - 1).long()
        byte = torch.gather(akb, 2, pos[:, None, None].expand(R, ns, 1))[..., 0]
        byte = torch.where(((plen + f)[:, None] < L) & valid, byte, 0)
        feats.append(byte.to(torch.uint8))
    return plen, prefix, torch.stack(feats, dim=1)


# --------------------------------------------------------------------------
# host (numpy) build — the parity reference's algorithm
# --------------------------------------------------------------------------

def _common_prefix_len(kb: np.ndarray, kl: np.ndarray) -> Tuple[int, np.ndarray]:
    """plen + prefix bytes over rows of a [k, L] anchor byte block."""
    L = kb.shape[1]
    if kb.shape[0] == 1:
        pl = int(min(kl[0], L))
        return pl, kb[0]
    eq = (kb == kb[:1]).all(axis=0)           # [L]
    neq = np.nonzero(~eq)[0]
    pl = int(neq[0]) if neq.size else L
    pl = int(min(pl, kl.min()))
    return pl, kb[0]


def _build_inner_level_np(cfg: TreeConfig, child_min_keyid: np.ndarray,
                          key_bytes: np.ndarray, key_lens: np.ndarray,
                          fill: int) -> Tuple[dict, np.ndarray]:
    """Group children into inner nodes; return level arrays + per-node min key id."""
    ns, fs, L = cfg.ns, cfg.fs, cfg.key_width
    n_child = child_min_keyid.shape[0]
    n_nodes = max(1, -(-n_child // fill))
    # balanced grouping
    base = n_child // n_nodes
    rem = n_child % n_nodes
    sizes = np.full(n_nodes, base, dtype=np.int64)
    sizes[:rem] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    knum = np.zeros(n_nodes, dtype=np.int32)
    plen = np.zeros(n_nodes, dtype=np.int32)
    prefix = np.zeros((n_nodes, L), dtype=np.uint8)
    features = np.zeros((n_nodes, fs, ns), dtype=np.uint8)
    children = np.full((n_nodes, ns), EMPTY, dtype=np.int32)
    anchors = np.full((n_nodes, ns), EMPTY, dtype=np.int32)
    node_min = np.zeros(n_nodes, dtype=np.int32)

    for i in range(n_nodes):
        s, k = int(starts[i]), int(sizes[i])
        ids = child_min_keyid[s:s + k]
        kb = key_bytes[ids]
        kl = key_lens[ids]
        pl, pfx = _common_prefix_len(kb, kl)
        knum[i] = k
        plen[i] = pl
        prefix[i] = pfx
        for f in range(fs):
            pos = pl + f
            if pos < L:
                features[i, f, :k] = kb[:, pos]
        children[i, :k] = np.arange(s, s + k, dtype=np.int32)
        anchors[i, :k] = ids
        node_min[i] = ids[0]
    return dict(knum=knum, plen=plen, prefix=prefix, features=features,
                children=children, anchors=anchors, count=np.int32(n_nodes)), node_min


def _check_capacity(cfg: TreeConfig, n: int) -> None:
    """Raise ValueError when ``n`` keys do not fit the config's caps."""
    def fail(msg: str):
        raise ValueError(f"bulk_build: {msg}")
    if n > cfg.key_cap:
        fail(f"key_cap exceeded ({n} > {cfg.key_cap})")
    if cfg.leaf_fill > cfg.ns or cfg.inner_fill > cfg.ns:
        fail("fill targets cannot exceed ns slots (TreeConfig.plan clamps "
             "them)")
    c = max(1, -(-n // cfg.leaf_fill))
    if c > cfg.leaf_cap:
        fail(f"leaf_cap exceeded ({c} > {cfg.leaf_cap})")
    for lvl in range(cfg.n_levels - 1, -1, -1):
        c = max(1, -(-c // cfg.inner_fill))
        if c > cfg.level_caps[lvl]:
            fail(f"level {lvl}: {c} > cap {cfg.level_caps[lvl]}")
    if c != 1:
        fail("tree too shallow for n_levels — use TreeConfig.plan")


def _to(a: np.ndarray, dev: torch.device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(a))
    return t.to(device=dev, dtype=dtype) if dtype is not None else t.to(dev)


def bulk_build(cfg: TreeConfig, ks: K.KeySet, vals: np.ndarray,
               device: bool = False, *, target: Optional[str] = None) -> FBTree:
    """Bulk-load a tree from (possibly unsorted) unique keys.

    ``device=False`` (default) runs the reference's host numpy build (sort
    on host, chunk the sorted run into balanced leaves, group bottom-up
    into inner levels, pad to the fixed height with single-child chain
    nodes), then moves every array to ``target`` once. ``device=True``
    runs the device pipeline on ``target`` (DESIGN.md §5): the packed-word
    sort of :func:`keys.lex_sort_indices_t`, then
    :func:`_device_build_from_sorted`. Both give bit-identical
    :class:`TreeArrays`, stacked layout included. ``target=None`` means the
    card and raises when there is none; pass ``target="cpu"`` for the CPU.

    Shapes: ``ks.bytes`` is ``uint8 [n, key_width]``, ``ks.lens`` ``int32
    [n]``, ``vals`` ``[n]`` (cast to ``cfg.val_dtype``). Raises ValueError
    on capacity overflow, checked on the host for both paths (the
    reference asserts).
    """
    dev = resolve_target(target)
    n = ks.n
    _check_capacity(cfg, n)
    if device:
        return _bulk_build_device(cfg, ks, vals, dev)
    ns, fs, L = cfg.ns, cfg.fs, cfg.key_width
    order = K.lex_sort_indices(ks)
    # every array gets one trailing scratch row (index cap) so masked scatters
    # have a conflict-free dump target; the watermarks never reach it.
    kb = np.zeros((cfg.key_cap + 1, L), dtype=np.uint8)
    kl = np.zeros((cfg.key_cap + 1,), dtype=np.int32)
    kb[:n] = ks.bytes[order]
    kl[:n] = ks.lens[order]
    vv = np.asarray(vals)[order]

    # ---- leaves ----
    fill = cfg.leaf_fill
    n_leaves = max(1, -(-n // fill))
    LC = cfg.leaf_cap + 1  # + scratch row
    leaf_tags = np.zeros((LC, ns), dtype=np.uint8)
    leaf_keyid = np.full((LC, ns), EMPTY, dtype=np.int32)
    leaf_val = np.zeros((LC, ns), dtype=np.asarray(vals).dtype)
    leaf_occ = np.zeros((LC, ns), dtype=bool)
    leaf_high = np.full((LC,), EMPTY, dtype=np.int32)
    leaf_next = np.full((LC,), EMPTY, dtype=np.int32)

    tags_all = K.fnv1a_tags(kb[:n], kl[:n])
    base = n // n_leaves
    rem = n % n_leaves
    sizes = np.full(n_leaves, base, dtype=np.int64)
    sizes[:rem] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    # the reference fills leaf i's first sizes[i] slots with key ids
    # starts[i] + slot; written here as one masked scatter over all leaves
    slot = np.arange(ns, dtype=np.int64)[None, :]
    mask = slot < sizes[:, None]                   # [n_leaves, ns]
    ids = (starts[:, None] + slot)[mask]           # row-major = sorted order
    leaf_keyid[:n_leaves][mask] = ids.astype(np.int32)
    leaf_val[:n_leaves][mask] = vv[ids]
    leaf_tags[:n_leaves][mask] = tags_all[ids]
    leaf_occ[:n_leaves][mask] = True
    leaf_min = starts.astype(np.int32)
    leaf_next[:n_leaves - 1] = np.arange(1, n_leaves, dtype=np.int32)
    leaf_high[:n_leaves - 1] = (starts + sizes)[:n_leaves - 1].astype(np.int32)

    # ---- inner levels bottom-up ----
    levels_np: List[dict] = []
    lvl_arrays, node_min = _build_inner_level_np(cfg, leaf_min, kb, kl, cfg.inner_fill)
    levels_np.append(lvl_arrays)
    while levels_np[-1]["knum"].shape[0] > 1:
        prev_n = levels_np[-1]["knum"].shape[0]
        lvl_arrays, node_min = _build_inner_level_np(cfg, node_min, kb, kl, cfg.inner_fill)
        levels_np.append(lvl_arrays)
        assert lvl_arrays["knum"].shape[0] < prev_n
    # pad to fixed height with single-child chain roots
    while len(levels_np) < cfg.n_levels:
        ids = node_min[:1]
        pl, pfx = _common_prefix_len(kb[ids], kl[ids])
        feat = np.zeros((1, fs, ns), dtype=np.uint8)
        for f in range(fs):
            if pl + f < L:
                feat[0, f, 0] = kb[ids[0], pl + f]
        levels_np.append(dict(
            knum=np.array([1], np.int32), plen=np.array([pl], np.int32),
            prefix=pfx[None].copy(), features=feat,
            children=np.full((1, ns), EMPTY, np.int32),
            anchors=np.full((1, ns), EMPTY, np.int32),
            count=np.int32(1)))
        levels_np[-1]["children"][0, 0] = 0
        levels_np[-1]["anchors"][0, 0] = ids[0]
    levels_np = levels_np[::-1]  # root first
    if len(levels_np) != cfg.n_levels:
        raise ValueError(f"bulk_build: built {len(levels_np)} levels for "
                         f"n_levels={cfg.n_levels}")

    # pad each level to its cap (+1 scratch row)
    levels: List[Level] = []
    for li, lv in enumerate(levels_np):
        cap = cfg.level_caps[li]
        cur = lv["knum"].shape[0]

        def pad(a, fillv=0):
            out = np.full((cap + 1,) + a.shape[1:], fillv, dtype=a.dtype)
            out[:cur] = a
            return _to(out, dev)

        levels.append(Level(
            knum=pad(lv["knum"]), plen=pad(lv["plen"]),
            prefix=pad(lv["prefix"]), features=pad(lv["features"]),
            children=pad(lv["children"], EMPTY),
            anchors=pad(lv["anchors"], EMPTY),
            count=_to(np.asarray(lv["count"], np.int32), dev),
        ))

    ktags = np.zeros((cfg.key_cap + 1,), dtype=np.uint8)
    ktags[:n] = tags_all
    i32 = lambda x: _to(np.asarray(x, np.int32), dev)
    arrays = TreeArrays(
        key_bytes=_to(kb, dev), key_lens=_to(kl, dev),
        key_tags=_to(ktags, dev),
        key_count=i32(n),
        levels=tuple(levels),
        stacked=stack_levels(tuple(levels)),
        leaf_tags=_to(leaf_tags, dev), leaf_keyid=_to(leaf_keyid, dev),
        leaf_val=_to(leaf_val, dev, cfg.val_dtype),
        leaf_occ=_to(leaf_occ, dev),
        leaf_high=_to(leaf_high, dev), leaf_next=_to(leaf_next, dev),
        leaf_version=torch.zeros((LC,), dtype=torch.int32, device=dev),
        leaf_ordered=_to(np.arange(LC) < n_leaves, dev),
        leaf_count=i32(n_leaves),
    )
    return FBTree(cfg, arrays)


# --------------------------------------------------------------------------
# device build — sort and build on the target device (DESIGN.md §5)
# --------------------------------------------------------------------------

def _ceil_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return -torch.div(-a, b, rounding_mode="floor")


def _device_build_from_sorted(cfg: TreeConfig, kb: torch.Tensor,
                              kl: torch.Tensor, ktags: torch.Tensor,
                              vals: torch.Tensor, n
                              ) -> Tuple[TreeArrays, torch.Tensor]:
    """Construct :class:`TreeArrays` from a sorted, compacted key pool.

    Inputs are pool-shaped (``[key_cap + 1, ...]``) with rows ``[0, n)``
    holding the keys in ascending order and zeros everywhere else; ``n`` is
    a 0-d int32 tensor on the pool's device (``batch_ops.rebuild`` does not
    know the live count on the host) or a Python int. Nothing here waits
    for the device. Returns ``(arrays, error)`` where ``error`` (a 0-d bool
    tensor) flags a capacity overflow; the arrays are then shape-valid
    garbage and callers must discard them.

    The pipeline (DESIGN.md §5): balanced chunking of the sorted run into
    leaves via a pure gather grid (no scatter conflicts), then one bottom-up
    pass per inner level — uniform grouping plus
    :func:`recompute_inner_meta` segmented reductions. Grouping a
    single-child run yields exactly the host build's chain-node padding, so
    the result is bit-identical to the host path.
    """
    ns, fs = cfg.ns, cfg.fs
    KC = cfg.key_cap
    LC = cfg.leaf_cap + 1
    dev = kb.device
    i32 = torch.int32
    n = torch.as_tensor(n, dtype=i32, device=dev)
    lane = torch.arange(ns, dtype=i32, device=dev)

    # ---- leaves: balanced chunking of the sorted key run ----
    n_leaves = torch.clamp(_ceil_div(n, cfg.leaf_fill), min=1)
    base = torch.div(n, n_leaves, rounding_mode="floor")
    rem = n - base * n_leaves
    li = torch.arange(LC, dtype=i32, device=dev)
    lstart = chunk_start(li, base, rem)            # [LC]
    lsize = base + (li < rem).to(i32)
    lexists = li < n_leaves
    pos = lstart[:, None] + lane[None, :]          # key id at (leaf, slot)
    lvalid = lexists[:, None] & (lane[None, :] < lsize[:, None]) & (pos < n)
    pos_safe = torch.clamp(pos, 0, KC).long()
    leaf_keyid = torch.where(lvalid, pos, EMPTY).to(i32)
    leaf_val = torch.where(lvalid, vals[pos_safe], 0).to(cfg.val_dtype)
    leaf_tags = torch.where(lvalid, ktags[pos_safe], 0).to(torch.uint8)
    nxt_ok = lexists & (li + 1 < n_leaves)
    leaf_high = torch.where(nxt_ok, chunk_start(li + 1, base, rem),
                            EMPTY).to(i32)
    leaf_next = torch.where(nxt_ok, li + 1, EMPTY).to(i32)
    # a chunk wider than ns would silently truncate at the lane mask — flag
    # it (the host path raises on the same fill > ns misconfiguration)
    err = (n_leaves > cfg.leaf_cap) | (torch.where(lexists, lsize, 0)
                                       > ns).any()

    # ---- inner levels bottom-up (a Python loop over the static height
    # only); grouping a 1-child run reproduces the host chain padding ----
    child_min = torch.where(lexists, lstart, 0)    # min key id per child
    n_child = n_leaves
    child_cap = LC
    levels_rev: List[Level] = []
    for lvl in range(cfg.n_levels - 1, -1, -1):
        Cn = cfg.level_caps[lvl] + 1
        n_nodes = torch.clamp(_ceil_div(n_child, cfg.inner_fill), min=1)
        nb = torch.div(n_child, n_nodes, rounding_mode="floor")
        nr = n_child - nb * n_nodes
        ni = torch.arange(Cn, dtype=i32, device=dev)
        nstart = chunk_start(ni, nb, nr)
        nsize = nb + (ni < nr).to(i32)
        nexists = ni < n_nodes
        cpos = nstart[:, None] + lane[None, :]     # child id at (node, slot)
        nvalid = (nexists[:, None] & (lane[None, :] < nsize[:, None])
                  & (cpos < n_child))
        cpos_safe = torch.clamp(cpos, 0, child_cap - 1).long()
        children = torch.where(nvalid, cpos, EMPTY).to(i32)
        anchors = torch.where(nvalid, child_min[cpos_safe], EMPTY).to(i32)
        knum = torch.where(nexists, nsize, 0).to(i32)
        pl, pf, ft = recompute_inner_meta(kb, kl, anchors, knum, fs)
        levels_rev.append(Level(
            knum=knum,
            plen=torch.where(nexists, pl, 0).to(i32),
            prefix=torch.where(nexists[:, None], pf, 0).to(torch.uint8),
            features=torch.where(nexists[:, None, None], ft, 0
                                 ).to(torch.uint8),
            children=children, anchors=anchors,
            count=n_nodes.to(i32)))
        err = (err | (n_nodes > cfg.level_caps[lvl])
               | (torch.where(nexists, nsize, 0) > ns).any())
        child_min = torch.where(
            nexists, child_min[torch.clamp(nstart, 0, child_cap - 1).long()],
            0)
        n_child = n_nodes
        child_cap = Cn
    err = err | (n_child != 1)                     # root must be one node
    levels = tuple(levels_rev[::-1])

    arrays = TreeArrays(
        key_bytes=kb, key_lens=kl, key_tags=ktags,
        key_count=n,
        levels=levels,
        stacked=stack_levels(levels),
        leaf_tags=leaf_tags, leaf_keyid=leaf_keyid, leaf_val=leaf_val,
        leaf_occ=lvalid,
        leaf_high=leaf_high, leaf_next=leaf_next,
        leaf_version=torch.zeros((LC,), dtype=i32, device=dev),
        leaf_ordered=lexists,
        leaf_count=n_leaves.to(i32),
    )
    return arrays, err


def _bulk_build_device(cfg: TreeConfig, ks: K.KeySet, vals,
                       dev: torch.device) -> FBTree:
    """``bulk_build(device=True)`` body: device sort, then the build core,
    both on ``dev``."""
    n, L = ks.n, cfg.key_width
    qb = torch.from_numpy(np.ascontiguousarray(ks.bytes)).to(dev)
    ql = torch.from_numpy(np.asarray(ks.lens, np.int32)).to(dev)
    order = K.lex_sort_indices_t(qb, ql)
    KC1 = cfg.key_cap + 1
    kb = torch.zeros((KC1, L), dtype=torch.uint8, device=dev)
    kb[:n] = qb[order]
    kl = torch.zeros((KC1,), dtype=torch.int32, device=dev)
    kl[:n] = ql[order]
    ktags = torch.zeros((KC1,), dtype=torch.uint8, device=dev)
    ktags[:n] = K.fnv1a_tags(qb, ql)[order]
    vv = torch.zeros((KC1,), dtype=cfg.val_dtype, device=dev)
    vv[:n] = torch.as_tensor(np.asarray(vals)).to(dev, cfg.val_dtype)[order]
    del qb, ql, order
    arrays, err = _device_build_from_sorted(cfg, kb, kl, ktags, vv, n)
    # _check_capacity already vetted n on the host; err re-validates it
    if bool(err):  # pragma: no cover - unreachable after _check_capacity
        raise RuntimeError("bulk_build(device=True): capacity exceeded")
    return FBTree(cfg, arrays)


# --------------------------------------------------------------------------
# shard-aware build entry (DESIGN.md §7)
# --------------------------------------------------------------------------

def sharded_partition(ks: K.KeySet, vals, n_shards: int,
                      presorted: bool = False):
    """Range-partition a key set for a sharded build (host numpy, as the
    reference's): one global lexicographic sort (``keys.lex_sort_indices``,
    the order every build path uses; skipped with ``presorted=True`` for
    inputs already in that order), then a balanced contiguous split into
    ``n_shards`` runs. Returns ``(parts, split_keys)``: ``parts[s]`` is
    ``(KeySet, vals)``, shard ``s``'s sorted slice, ready for its own
    :func:`bulk_build`; ``split_keys[s]`` is ``(bytes_row uint8[L], len)``,
    the run's minimum key (shard ``s`` owns ``[split_keys[s],
    split_keys[s+1])``, shard 0 also everything below ``split_keys[0]``).

    Raises ValueError unless ``1 <= n_shards <= n`` (an empty shard has no
    minimum key to route by); shard sizes differ by at most one.
    """
    n = ks.n
    if n_shards < 1:
        raise ValueError(f"sharded_partition: n_shards must be >= 1, "
                         f"got {n_shards}")
    if n < n_shards:
        raise ValueError(
            f"sharded_partition needs at least one key per shard "
            f"(n={n} < n_shards={n_shards}): an empty shard has no "
            f"minimum key for the router — lower n_shards or seed "
            f"sentinel keys")
    if presorted:
        sb, sl, sv = ks.bytes, ks.lens, np.asarray(vals)
    else:
        order = K.lex_sort_indices(ks)
        sb = ks.bytes[order]
        sl = ks.lens[order]
        sv = np.asarray(vals)[order]
    base, rem = divmod(n, n_shards)
    parts = []
    split_keys = []
    start = 0
    for s in range(n_shards):
        k = base + (1 if s < rem else 0)
        parts.append((K.KeySet(sb[start:start + k].copy(),
                               sl[start:start + k].copy()),
                      sv[start:start + k].copy()))
        split_keys.append((sb[start].copy(), int(sl[start])))
        start += k
    return parts, split_keys
