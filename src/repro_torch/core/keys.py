"""Key handling for the FB+-tree port: order-preserving byte encodings and
key sets (counterpart of ``repro.core.keys``).

Keys are arbitrary byte strings. On the device they live in a fixed-width,
zero-padded ``uint8[N, max_key_len]`` tensor plus ``int32[N]`` lengths.
Order is lexicographic over bytes with a length tie-break, which equals
true bytes-order as long as comparisons fall back to length when the
padded bytes are identical.

The host-side functions (encoders, :func:`make_keyset`, :func:`pack_words`,
:func:`lex_sort_indices`) are numpy and copied as they are; the tree's host
build runs on them. :func:`pack_words_t` and :func:`compare_padded` are
torch twins of the reference's jnp functions, and :func:`fnv1a_tags` takes
numpy arrays (the host build) or torch tensors alike.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

__all__ = [
    "KeySet",
    "encode_uint64",
    "encode_int64",
    "decode_uint64",
    "make_keyset",
    "pack_words",
    "pack_words_t",
    "lex_sort_indices",
    "lex_sort_indices_t",
    "compare_padded",
    "fnv1a_tags",
]

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_U32 = 0xFFFFFFFF


def encode_uint64(x: Union[int, np.ndarray]) -> np.ndarray:
    """uint64 -> big-endian 8 bytes (order-preserving)."""
    x = np.asarray(x, dtype=np.uint64)
    out = np.empty(x.shape + (8,), dtype=np.uint8)
    for i in range(8):
        out[..., i] = ((x >> np.uint64(8 * (7 - i))) & np.uint64(0xFF)).astype(np.uint8)
    return out


def encode_int64(x: Union[int, np.ndarray]) -> np.ndarray:
    """int64 -> order-preserving 8 bytes via sign-bit flip (paper §3.6)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.int64))
    flipped = x.view(np.uint64) ^ np.uint64(1 << 63)
    return encode_uint64(flipped)


def decode_uint64(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, dtype=np.uint64)
    acc = np.zeros(b.shape[:-1], dtype=np.uint64)
    for i in range(8):
        acc = (acc << np.uint64(8)) | b[..., i]
    return acc


class KeySet(NamedTuple):
    """Fixed-width padded key batch (host numpy)."""

    bytes: np.ndarray  # uint8 [N, L] zero padded
    lens: np.ndarray   # int32 [N]

    @property
    def n(self) -> int:
        return int(self.bytes.shape[0])

    @property
    def width(self) -> int:
        return int(self.bytes.shape[1])


def make_keyset(keys: Sequence[Union[bytes, str, int]], max_key_len: int,
                int_mode: str = "uint64") -> KeySet:
    """Build a KeySet from python keys (bytes / str / int)."""
    rows = []
    lens = []
    for k in keys:
        if isinstance(k, str):
            k = k.encode("utf-8")
        if isinstance(k, (int, np.integer)):
            k = (encode_int64(int(k)) if int_mode == "int64"
                 else encode_uint64(int(k))).tobytes()
        if len(k) > max_key_len:
            raise ValueError(f"key longer than max_key_len={max_key_len}: {len(k)}")
        rows.append(k)
        lens.append(len(k))
    arr = np.zeros((len(rows), max_key_len), dtype=np.uint8)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
    return KeySet(arr, np.asarray(lens, dtype=np.int32))


def pack_words(kb: np.ndarray) -> np.ndarray:
    """Pack uint8 [.., L] into big-endian int32 words [.., ceil(L/4)].

    Packed words compare (as *unsigned*; we bias to keep int32 order correct)
    in the same order as the bytes, enabling O(L/4) lexsort keys.
    """
    L = kb.shape[-1]
    Lp = (L + 3) // 4 * 4
    if Lp != L:
        pad = np.zeros(kb.shape[:-1] + (Lp - L,), dtype=np.uint8)
        kb = np.concatenate([kb, pad], axis=-1)
    w = kb.reshape(kb.shape[:-1] + (Lp // 4, 4)).astype(np.uint32)
    words = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]
    # bias so that int32 ordering == unsigned ordering
    return (words.astype(np.int64) - (1 << 31)).astype(np.int32)


def pack_words_t(kb: torch.Tensor) -> torch.Tensor:
    """torch twin of :func:`pack_words` (order-preserving int32 words),
    one :func:`_word_t` column per word."""
    return torch.stack([_word_t(kb, i) for i in range((kb.shape[-1] + 3) // 4)],
                       dim=-1)


def _word_t(kb: torch.Tensor, i: int) -> torch.Tensor:
    """Word ``i`` of :func:`pack_words_t` alone: bytes ``4i .. 4i+3``
    big-endian (0 past the key width), computed in int64, then biased by
    ``2**31`` into int32 range, so no uint32 arithmetic is needed."""
    w = torch.zeros(kb.shape[:-1], dtype=torch.int64, device=kb.device)
    for j in range(4):
        w = w << 8
        if 4 * i + j < kb.shape[-1]:
            w = w | kb[..., 4 * i + j].to(torch.int64)
    return (w - (1 << 31)).to(torch.int32)


def lex_sort_indices(ks: KeySet) -> np.ndarray:
    """Indices that sort the KeySet lexicographically (bytes, then length)."""
    words = pack_words(ks.bytes)  # [N, W]
    cols = [ks.lens] + [words[:, i] for i in range(words.shape[1] - 1, -1, -1)]
    return np.lexsort(cols)


def lex_sort_indices_t(kb: torch.Tensor, kl: torch.Tensor,
                       invalid: torch.Tensor = None) -> torch.Tensor:
    """torch twin of the reference's ``lex_sort_indices_j``: the device
    argsort of padded keys by (bytes asc, length tie-break), optionally
    pushing rows flagged by the bool mask ``invalid`` past every valid row.
    The single definition of the device key order: the build, the rebuild
    and the insert path's dedupe sort through it.

    torch has no ``lexsort``: stable sorts are chained from the least
    significant column up (length, then the packed words from last to
    first, then ``invalid`` as int32), so equal rows keep their input order
    as ``jnp.lexsort``'s do. Each word column is packed only when its sort
    runs, so no ``[N, L]`` int64 copy of the keys is made. Returns int64
    ``[N]``.
    """
    perm = torch.argsort(kl, stable=True)
    for i in range((kb.shape[-1] + 3) // 4 - 1, -1, -1):
        perm = perm[torch.argsort(_word_t(kb, i)[perm], stable=True)]
    if invalid is not None:
        perm = perm[torch.argsort(invalid.to(torch.int32)[perm], stable=True)]
    return perm


def compare_padded(a_bytes: torch.Tensor, a_len: torch.Tensor,
                   b_bytes: torch.Tensor, b_len: torch.Tensor) -> torch.Tensor:
    """Vectorized 3-way compare (-1/0/1) on padded keys with length
    tie-break (torch twin of the reference's ``compare_padded``). Shapes
    broadcast on the leading dims; last dim is key width."""
    diff = a_bytes.to(torch.int32) - b_bytes.to(torch.int32)
    nz = diff != 0
    width = diff.shape[-1]
    pos = torch.arange(width, dtype=torch.int64, device=diff.device)
    first_idx = torch.where(nz, pos, width).amin(-1).clamp(max=width - 1)
    first = torch.gather(diff, -1, first_idx.unsqueeze(-1)).squeeze(-1)
    len_cmp = torch.sign(a_len.to(torch.int32) - b_len.to(torch.int32))
    return torch.where(nz.any(-1), torch.sign(first), len_cmp).to(torch.int32)


def fnv1a_tags(kb, klen):
    """1-byte FNV-1a-style fingerprints over the valid bytes of each key.

    Takes torch tensors or numpy arrays; masked positions contribute the
    identity. The FNV multiply wraps in uint32: the torch path computes in
    int64 and masks with ``0xFFFFFFFF`` after every multiply, which gives
    the same bits (the product of two values below 2**32 and 2**25 fits in
    int64).
    """
    if not isinstance(kb, torch.Tensor):
        return _fnv1a_tags_np(kb, klen)
    L = kb.shape[-1]
    h = torch.full(kb.shape[:-1], _FNV_OFFSET, dtype=torch.int64,
                   device=kb.device)
    klen = klen.to(torch.int64)
    for i in range(L):
        byte = kb[..., i].to(torch.int64)
        nh = ((h ^ byte) * _FNV_PRIME) & _U32
        h = torch.where(i < klen, nh, h)
    h = (h ^ (h >> 16)) & 0xFFFF
    h = (h ^ (h >> 8)) & 0xFF
    return h.to(torch.uint8)


def _fnv1a_tags_np(kb: np.ndarray, klen: np.ndarray) -> np.ndarray:
    L = kb.shape[-1]
    h = np.full(kb.shape[:-1], _FNV_OFFSET, dtype=np.uint32)
    for i in range(L):
        valid = i < klen
        byte = kb[..., i].astype(np.uint32)
        nh = (h ^ byte) * np.uint32(_FNV_PRIME)
        h = np.where(valid, nh, h)
    h = (h ^ (h >> 16)) & np.uint32(0xFFFF)
    h = (h ^ (h >> 8)) & np.uint32(0xFF)
    return h.astype(np.uint8)
