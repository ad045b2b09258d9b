"""TPC-C's CUSTOMER population, keyed as its by-name index reads it.

TPC-C Standard Specification, Revision 5.11 (tpc.org):

* 4.3.3.1: each warehouse has 10 districts and each district 3,000
  customers, ``C_ID`` 1 to 3,000. ``C_LAST`` is made by 4.3.2.3 from the
  numbers 0 to 999 in order for the first 1,000 customers of a district,
  and from ``NURand(255, 0, 999)`` for the other 2,000. ``C_FIRST`` is a
  random a-string of 8 to 16 characters.
* 4.3.2.3: ``C_LAST`` is three syllables of BAR, OUGHT, ABLE, PRI, PRES,
  ESE, ANTI, CALLY, ATION, EING, picked by the digits of the number
  written with three digits (371 is PRICALLYOUGHT, 40 BARPRESBAR).
* 2.1.6: ``NURand(A, x, y) = (((random(0, A) | random(x, y)) + C) %
  (y - x + 1)) + x``, with one constant ``C`` in ``[0, A]`` for the load
  (``C_LOAD``).
* 2.5.2.2 and 2.6.2.2: Payment and Order-Status select customers by
  ``(C_W_ID, C_D_ID, C_LAST)`` in the order of ``C_FIRST``, so an
  engine keeps an ordered index on ``(C_W_ID, C_D_ID, C_LAST,
  C_FIRST)``.

Record ``i`` is customer ``(w, d, c)``: warehouse ``w = i // 30,000 + 1``,
district ``d = i // 3,000 % 10 + 1``, ``C_ID`` ``c = i % 3,000 + 1``. Its
key is ``C_W_ID`` and ``C_D_ID`` as 4 big-endian bytes each, ``C_LAST``
zero-padded to its 16 bytes, then ``C_FIRST``: 32 to 40 bytes, in the
byte order of ``(C_W_ID, C_D_ID, C_LAST, C_FIRST)``. ``C_FIRST`` is drawn
from the 62 letters and digits. ``C_LOAD`` and every ``C_FIRST`` come
from :data:`POPULATION_SEED`, not from a run's seed: every run loads one
database (2.1.6.1 chooses ``C`` apart from the runs), and the run's seed
draws the requests. A ``C_FIRST`` that would repeat a whole key is drawn
again.

The draws are numpy's, in this order, so that every machine makes the same
keys: ``C_LOAD``; for each district, the two randoms of each of its 2,000
``NURand`` calls (all of ``random(0, 255)``, then all of ``random(0,
999)``); every record's ``C_FIRST`` length, then every record's 16
characters (those past its length unused), drawn four at a time; then, a
pass at a time, new lengths and characters for the repeats, in record
order. The keys are put together on the device.
"""
import numpy as np
import torch

WIDTH = 40
DISTRICTS = 10                 # districts a warehouse (4.3.3.1)
CUSTOMERS = 3000               # customers a district (4.3.3.1)
NAMED_IN_ORDER = 1000          # customers named by the numbers 0-999 in order
SYLLABLES = ("BAR", "OUGHT", "ABLE", "PRI", "PRES", "ESE", "ANTI", "CALLY",
             "ATION", "EING")  # 4.3.2.3
ID_BYTES, LAST_BYTES = 4, 16   # C_W_ID, C_D_ID; C_LAST's field
FIRST_AT = 2 * ID_BYTES + LAST_BYTES
FIRST_MIN, FIRST_MAX = 8, 16   # C_FIRST: a-string [8 .. 16]
ALNUM = b"0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
NURAND_A = 255                 # NURand(255, 0, 999) for C_LAST
POPULATION_SEED = 511          # chosen once, as YCSB's constants are


def last_name(num: int) -> str:
    """4.3.2.3: the ``C_LAST`` of a number in ``[0, 999]``."""
    return "".join(SYLLABLES[int(c)] for c in f"{num:03d}")


def nurand(r_a, r_xy, c):
    """2.1.6's ``NURand(255, 0, 999)`` from its two randoms and ``C``."""
    return ((r_a | r_xy) + c) % 1000


def last_numbers(n_districts: int, rng):
    """``(C_LOAD, int16 [n_districts, 3000])``: each customer's ``C_LAST``
    number, district by district, and the ``C`` they were made with."""
    c_load = int(rng.integers(0, NURAND_A + 1))
    m = CUSTOMERS - NAMED_IN_ORDER
    r_a = rng.integers(0, NURAND_A + 1, size=(n_districts, m), dtype=np.int16)
    r_xy = rng.integers(0, 1000, size=(n_districts, m), dtype=np.int16)
    num = np.empty((n_districts, CUSTOMERS), dtype=np.int16)
    num[:, :NAMED_IN_ORDER] = np.arange(NAMED_IN_ORDER, dtype=np.int16)
    num[:, NAMED_IN_ORDER:] = nurand(r_a, r_xy, np.int16(c_load))
    return c_load, num


def first_draws(k: int, rng):
    """``(lengths uint8 [k], quads uint32 [k, 4])`` of ``k`` ``C_FIRST``
    draws: each quad is four characters, the base-62 digits of a number
    below ``62 ** 4``, first character most significant (one draw for four
    characters, four times fewer than a draw a character)."""
    flen = rng.integers(FIRST_MIN, FIRST_MAX + 1, size=k, dtype=np.uint8)
    quads = rng.integers(0, len(ALNUM) ** 4, size=(k, FIRST_MAX // 4),
                         dtype=np.uint32)
    return flen, quads


def first_chars(quads: torch.Tensor) -> torch.Tensor:
    """The characters of each row of quads, as indices into :data:`ALNUM`:
    int64 ``[k, 16]``."""
    q = quads.long()
    digits = [torch.div(q, len(ALNUM) ** (3 - i), rounding_mode="floor")
              % len(ALNUM) for i in range(4)]
    return torch.stack(digits, 2).reshape(q.shape[0], -1)


def _first_rows(flen, quads, device):
    """``C_FIRST`` as zero-padded byte rows ``[k, 16]`` on ``device``."""
    flen = torch.from_numpy(flen).to(device)
    chars = first_chars(torch.from_numpy(quads).to(device))
    table = torch.tensor(list(ALNUM), dtype=torch.uint8, device=device)
    j = torch.arange(FIRST_MAX, device=device)
    return table[chars] * (j < flen[:, None].long()), flen


def _be(x: torch.Tensor) -> torch.Tensor:
    """Each int64 as ``ID_BYTES`` big-endian bytes."""
    shift = 8 * torch.arange(ID_BYTES - 1, -1, -1, device=x.device)
    return ((x[:, None] >> shift) & 0xFF).to(torch.uint8)


def repeats(group: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Rows whose ``(group, C_FIRST)`` an earlier row has: bool ``[n]``.
    ``C_FIRST`` holds no zero byte, so its padded row fixes its length."""
    cols = [group] + [
        sum(first[:, 8 * h + k].long() << (8 * (7 - k)) for k in range(8))
        for h in range(FIRST_MAX // 8)]
    perm = torch.arange(group.shape[0], device=group.device)
    for c in reversed(cols):                   # stable: equal rows by index
        perm = perm[torch.argsort(c[perm], stable=True)]
    same = torch.ones(group.shape[0] - 1, dtype=torch.bool, device=group.device)
    for c in cols:
        s = c[perm]
        same &= s[1:] == s[:-1]
    out = torch.zeros(group.shape[0], dtype=torch.bool, device=group.device)
    out[perm[1:]] = same
    return out


def generate(n: int, seed: int, device):
    """The keys of customers ``0 .. n - 1`` in record order (``seed`` is
    not used: the population has its own, :data:`POPULATION_SEED`)."""
    if n <= 0 or n % CUSTOMERS:
        raise ValueError(f"{n} customers are not a whole number of districts "
                         f"of {CUSTOMERS}")
    rng = np.random.default_rng(POPULATION_SEED)
    _, num = last_numbers(n // CUSTOMERS, rng)
    first, flen = _first_rows(*first_draws(n, rng), device)

    rec = torch.arange(n, dtype=torch.int64, device=device)
    dist = torch.div(rec, CUSTOMERS, rounding_mode="floor")   # 0-based
    num = torch.from_numpy(num.reshape(-1)).to(device).long()
    group = dist * 1000 + num
    while True:
        again = torch.nonzero(repeats(group, first))[:, 0]
        if again.numel() == 0:
            break
        first[again], flen[again] = _first_rows(*first_draws(
            again.numel(), rng), device)

    names = b"".join(last_name(i).encode().ljust(LAST_BYTES, b"\0")
                     for i in range(1000))
    names = torch.frombuffer(bytearray(names), dtype=torch.uint8).reshape(
        1000, LAST_BYTES).to(device)
    kb = torch.cat([
        _be(torch.div(dist, DISTRICTS, rounding_mode="floor") + 1),
        _be(dist % DISTRICTS + 1), names[num], first], 1)
    return kb, (FIRST_AT + flen.to(torch.int32))
