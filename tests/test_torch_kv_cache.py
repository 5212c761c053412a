"""The port's page-pool bookkeeping against the reference's.

`repro_torch.launch.kv_cache.PageTable` and `prefix_keys` are copies of the
reference's host-numpy code. Random traces over the full action set
(admit, shared admit with and without deferred indexing, index_pages,
extend, copy-on-write fork, swap out/in, retire, and the queries), valid
and invalid calls alike, must give the same return value or the same error
and leave both tables in the same state after every step.
"""
import random

import numpy as np
import pytest

from repro.launch import kv_cache as jkv
from repro_torch.launch import kv_cache as tkv


def _plain(v):
    """Return values as comparable Python values."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _call(pt, name, *args, **kw):
    try:
        return ("ok", _plain(getattr(pt, name)(*args, **kw)))
    except Exception as e:                 # the error is part of the result
        return ("raised", type(e).__name__, str(e))


def _state(pt):
    return (pt.table.tolist(), pt.held.tolist(), pt.tokens.tolist(),
            pt.active.tolist(), pt.refcount.tolist(), list(pt._free),
            dict(pt._index), dict(pt._page_key), pt.stats())


def _keys(stream: int, n: int, page_size: int) -> list:
    """Share keys of one prompt stream: two admits of the same stream alias
    pages wherever their covered token counts line up."""
    ks, c = [], 0
    while c < n:
        c = min(c + page_size, n)
        ks.append((stream, c))
    return ks


@pytest.mark.parametrize("seed", range(12))
def test_page_table_matches_reference_on_random_traces(seed):
    rng = random.Random(seed)
    page_size = rng.choice([1, 2, 4, 8])
    slots = rng.randint(1, 5)
    max_pages = rng.randint(1, 6)
    num_pages = rng.randint(2, slots * max_pages + 4)
    cap = max_pages * page_size
    pts = [m.PageTable(num_pages, page_size, slots, max_pages) for m in (jkv, tkv)]
    assert _state(pts[0]) == _state(pts[1])
    for step in range(150):
        s = rng.randrange(slots)
        n = rng.randint(0, cap + 1)          # 0 and cap + 1 are refused
        keys = _keys(rng.randrange(3), max(n, 1), page_size)
        op = rng.choice(["admit", "admit_shared", "index_pages", "extend",
                         "fork_cow", "swap_out", "swap_in", "retire",
                         "lookup_keys", "can_admit", "cow_pending"])
        args = {"admit": (s, n),
                "admit_shared": (s, n, keys),
                "index_pages": (s, keys, rng.randint(0, n)),
                "extend": (s, n),
                "fork_cow": (s, rng.randrange(cap)),
                "swap_out": (s,), "swap_in": (s, n), "retire": (s,),
                "lookup_keys": (keys,), "can_admit": (n,),
                "cow_pending": (s, rng.randrange(cap))}[op]
        kw = {"defer_index": rng.random() < 0.5} if op == "admit_shared" else {}
        want, got = (_call(pt, op, *args, **kw) for pt in pts)
        assert got == want, (step, op, args, kw)
        assert _state(pts[1]) == _state(pts[0]), (step, op, args, kw)


@pytest.mark.parametrize("page_size", [1, 3, 16])
def test_prefix_keys_match_reference(page_size):
    rng = np.random.default_rng(page_size)
    for n in (1, page_size, 2 * page_size + 1, 40):
        toks = rng.integers(0, 128256, size=n).astype(np.int32)
        for ns in (b"", b"model-a"):
            assert (tkv.prefix_keys(toks, page_size, namespace=ns)
                    == jkv.prefix_keys(toks, page_size, namespace=ns))
    assert tkv.pages_for(33, 16) == jkv.pages_for(33, 16) == 3
