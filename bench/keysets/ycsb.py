"""YCSB's own key names: record ``i`` is ``user`` followed by the decimal
digits of ``fnvhash64(i)``, as ``CoreWorkload.buildKeyName`` makes them
under YCSB's defaults (``insertorder=hashed``, ``zeropadding=1``):

    github.com/brianfrankcooper/YCSB/blob/master/core/src/main/java/site/ycsb/workloads/CoreWorkload.java
    github.com/brianfrankcooper/YCSB/blob/master/core/src/main/java/site/ycsb/Utils.java

``fnvhash64`` is FNV-1a over the eight low-first bytes of the record
number, its result made non-negative by ``Math.abs``: 5 to 23 bytes a key
(19 digits for nine in ten keys), in a 24-byte row. YCSB's key names do
not depend on a seed, and neither do these: every run loads the same keys,
and the seed draws the requests (``bench/dists/scrambled_zipfian.py``).
The hash and the digits are worked out on the device, in int64 arithmetic
that wraps as Java's ``long`` does.
"""
import torch

WIDTH = 24
FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325 - (1 << 64)    # as a Java long
FNV_PRIME_64 = 1099511628211
DIGITS = 19


def fnvhash64(val: torch.Tensor) -> torch.Tensor:
    """YCSB's ``Utils.fnvhash64`` of each non-negative int64 in ``val``."""
    h = torch.full_like(val, FNV_OFFSET_BASIS_64)
    for _ in range(8):
        h = (h ^ (val & 0xFF)) * FNV_PRIME_64
        val = val >> 8
    return torch.abs(h)


def key_names(nums: torch.Tensor):
    """``user`` + the decimal digits of each non-negative int64, with no
    zero padding: ``(kb uint8 [n, 24], kl int32 [n])``."""
    n, dev = nums.shape[0], nums.device
    digits = torch.stack([
        torch.div(nums, 10 ** (DIGITS - 1 - i), rounding_mode="floor") % 10
        for i in range(DIGITS)], 1)
    lead = (digits != 0).to(torch.int8).argmax(1)       # 0 -> "0", one digit
    lead = torch.where(nums == 0, DIGITS - 1, lead)
    ndig = DIGITS - lead
    j = torch.arange(DIGITS, device=dev)
    src = torch.clamp(lead[:, None] + j, max=DIGITS - 1)
    row = (digits.gather(1, src) + ord("0")) * (j < ndig[:, None])
    kb = torch.zeros((n, WIDTH), dtype=torch.uint8, device=dev)
    kb[:, :4] = torch.tensor(list(b"user"), dtype=torch.uint8, device=dev)
    kb[:, 4:4 + DIGITS] = row.to(torch.uint8)
    return kb, (4 + ndig).to(torch.int32)


def generate(n: int, seed: int, device):
    """The key names of records ``0 .. n - 1``, record ``i`` in row ``i``
    (``seed`` is not used: YCSB's key names have none)."""
    h = fnvhash64(torch.arange(n, dtype=torch.int64, device=device))
    if torch.unique(h).numel() != n:
        raise ValueError(f"two of YCSB's first {n} record numbers hash alike")
    return key_names(h)
