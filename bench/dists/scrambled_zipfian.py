"""YCSB's request distribution ``requestdistribution=zipfian``: the
``ScrambledZipfianGenerator`` that ``CoreWorkload`` picks for it, and
``CoreWorkload.nextKeynum``'s redraw of record numbers not yet loaded:

    github.com/brianfrankcooper/YCSB/blob/master/core/src/main/java/site/ycsb/generator/ScrambledZipfianGenerator.java
    github.com/brianfrankcooper/YCSB/blob/master/core/src/main/java/site/ycsb/generator/ZipfianGenerator.java

A rank is drawn zipfian (theta 0.99) over ``ITEM_COUNT`` items by
``ZipfianGenerator.nextLong``'s closed form, with YCSB's precomputed
``ZETAN``; the record is ``fnvhash64(rank) % itemcount``, ``itemcount``
being the loaded records plus one (YCSB's generator spans ``[0,
recordcount]``), and a record past the loaded ones is drawn again. The
scramble is a hash, so the hot records are the same in every run, as in
YCSB: the seed draws the uniforms, so the order of the requests. They are
drawn with numpy from the seed; the rest runs on the device.
"""
import numpy as np
import torch

from ..keysets.ycsb import fnvhash64

THETA = 0.99                  # ScrambledZipfianGenerator.USED_ZIPFIAN_CONSTANT
ZETAN = 26.46902820178302     # ScrambledZipfianGenerator.ZETAN
ITEM_COUNT = 10_000_000_000   # ScrambledZipfianGenerator.ITEM_COUNT


def _ranks(u: torch.Tensor) -> torch.Tensor:
    """``ZipfianGenerator.nextLong`` over ``[0, ITEM_COUNT]`` for uniforms
    ``u`` (float64)."""
    items = ITEM_COUNT + 1
    zeta2 = 1.0 + 0.5 ** THETA
    alpha = 1.0 / (1.0 - THETA)
    eta = (1.0 - (2.0 / items) ** (1.0 - THETA)) / (1.0 - zeta2 / ZETAN)
    uz = u * ZETAN
    ret = (items * torch.pow(eta * u - eta + 1.0, alpha)).to(torch.int64)
    return torch.where(uz < 1.0, 0, torch.where(uz < zeta2, 1, ret))


def draw(rng, n_keys: int, shape, params: dict, device):
    if float(params["theta"]) != THETA:
        raise ValueError(f"YCSB's scrambled zipfian is defined for theta "
                         f"{THETA} (its ZETAN is precomputed for it)")
    out = torch.empty(shape, dtype=torch.int64, device=device).reshape(-1)
    todo = torch.arange(out.numel(), device=device)
    while todo.numel():
        u = torch.from_numpy(rng.random(todo.numel())).to(device)
        rec = fnvhash64(_ranks(u)) % (n_keys + 1)
        out[todo] = rec
        todo = todo[rec >= n_keys]
    return out.reshape(shape)
