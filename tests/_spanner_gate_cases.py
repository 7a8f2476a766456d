"""Hand-built sparse-spanner states and edge lists that drive each path of
the capped-degree gate (``gelly_torch/csrc/spanner_gate.cu``) and of its
batched append, shared by ``test_torch_spanner.py`` (a numpy model of the
kernel's decomposition held to ``gelly_tpu``) and ``test_torch_cuda.py``
(both kernel entries held to their plain versions on the card).

Each case gives a vertex count ``n``, the row cap ``D``, the frontier cap
``F``, the hop bound ``k``, the edge-list capacity ``E``, the rows of its
starting state (``{row: [ids]}``, every other row empty) and an edge list
``(src, dst)``: the per-edge entry's lanes (all valid) and the combine's
donor list. ``paths`` names the gate paths (see ``GATE_PATHS``) that some
lane of the case must take on the starting state.
"""

from __future__ import annotations

import numpy as np

# The paths of the gate, as the kernel's header comment names them:
#   keep        a round before the last with at most F raw ids: the raw
#               multiset is the next frontier, no dedup;
#   dedup       a round before the last with more than F raw ids but at
#               most F distinct ones: the distinct ids are the frontier;
#   select      a round before the last with more than F distinct ids:
#               the F smallest, by a bitwise threshold select;
#   last-miss   the last round does not hold v;
#   last-raw    it holds v with fewer than F raw ids below it;
#   last-dedup  it holds v with F or more raw ids below it: the distinct
#               ids below v decide.
GATE_PATHS = ("keep", "dedup", "select", "last-miss", "last-raw",
              "last-dedup")

_BELOW_ROWS = {50: [40, 41, 42, 43], 40: [10, 1, 2, 1], 41: [2, 3, 3, 1],
               42: [4, 4, 5, 1]}


def _below(row43, F=6):
    """k = 2: v = 10 two hops from u = 50, with ids 1-5 (and ``row43``'s)
    below it, each several times across rows and within one."""
    return {"n": 64, "D": 4, "F": F, "k": 2, "E": 64,
            "rows": {**_BELOW_ROWS, 43: row43},
            "src": [50, 10, 50, 40, 1], "dst": [10, 50, 3, 12, 11],
            "paths": {"keep", "last-dedup"}}


CASES = {
    # Exactly F - 1, F and F + 1 distinct ids below v (F = 6), each raw
    # id counted several times, so the last round dedups.
    "below-F-minus-1": _below([5, 5]),
    "below-F": _below([6, 2]),
    "below-F-plus-1": _below([6, 7, 7]),
    # v held with fewer than F raw ids below it: no dedup.
    "below-raw": {"n": 64, "D": 4, "F": 6, "k": 2, "E": 64,
                  "rows": {50: [40, 41], 40: [10, 1]},
                  "src": [50, 50, 41], "dst": [10, 1, 10],
                  "paths": {"keep", "last-raw", "last-miss"}},
    # v in round 1's frontier (a direct neighbour), and duplicates of it
    # in one row.
    "v-in-round-1": {"n": 64, "D": 4, "F": 6, "k": 2, "E": 64,
                     "rows": {50: [40, 10, 10], 40: [10, 2], 10: [50, 50]},
                     "src": [50, 10, 40, 2], "dst": [10, 50, 50, 50],
                     "paths": {"keep", "last-raw"}},
    # D + 1 > F: round 1 is cut to the F = 3 smallest of u and its row,
    # dropping a direct neighbour (44) that no later row brings back.
    "round-1-cut": {"n": 64, "D": 6, "F": 3, "k": 2, "E": 64,
                    "rows": {50: [40, 41, 42, 43, 44, 45], 40: [1],
                             42: [43]},
                    "src": [50, 50, 50, 50], "dst": [44, 41, 43, 1],
                    "paths": {"select", "last-miss", "last-raw",
                              "last-dedup"}},
    "k0": {"n": 64, "D": 4, "F": 6, "k": 0, "E": 64,
           "rows": {50: [40, 41], 40: [10]},
           "src": [50, 50, 10, 3], "dst": [40, 10, 10, 4], "paths": set()},
    # k = 1: the last round is the first; a row of one id four times.
    "k1": {"n": 64, "D": 4, "F": 3, "k": 1, "E": 64,
           "rows": {50: [40, 41, 42, 43], 51: [40, 40, 40, 41]},
           "src": [50, 50, 51, 51, 50], "dst": [42, 43, 41, 42, 9],
           "paths": {"last-raw", "last-dedup", "last-miss"}},
    # k = 3, round 2 with 17 raw ids but exactly F = 6 distinct.
    "k3-dedup": {"n": 64, "D": 4, "F": 6, "k": 3, "E": 64,
                 "rows": {50: [40, 41, 42, 43], 40: [50, 1, 1],
                          41: [50, 1], 42: [50], 43: [1], 1: [7]},
                 "src": [50, 50, 50], "dst": [7, 8, 1],
                 "paths": {"keep", "dedup", "last-raw", "last-miss"}},
    # k = 3, round 2 with F + 2 = 8 distinct ids: the threshold select
    # drops 45 and u itself; 45 comes back in round 3 through row 40.
    "k3-select": {"n": 64, "D": 4, "F": 6, "k": 3, "E": 64,
                  "rows": {50: [40, 41, 42, 43], 40: [45, 1], 41: [2],
                           45: [9], 1: [7]},
                  "src": [50, 50, 50, 50], "dst": [9, 45, 7, 60],
                  "paths": {"keep", "select", "last-miss", "last-dedup",
                            "last-raw"}},
    # k = 3 with exactly F + 1 distinct ids in round 2.
    "k3-select-F-plus-1": {"n": 64, "D": 4, "F": 6, "k": 3, "E": 64,
                           "rows": {50: [40, 41, 42, 43], 40: [45, 1],
                                    45: [9]},
                           "src": [50, 50], "dst": [9, 45],
                           "paths": {"keep", "select"}},
    # Row 5 one slot short of D = 4; the batch appends to it five times,
    # twice as the first endpoint and three times as the second, so pass
    # 2 starts where pass 1 left the row.
    "rows-fill-in-batch": {"n": 64, "D": 4, "F": 16, "k": 2, "E": 64,
                           "rows": {5: [20, 21, 22]},
                           "src": [31, 5, 33, 5, 34, 36],
                           "dst": [5, 30, 5, 32, 35, 5],
                           "paths": {"keep", "last-miss"}},
    # Candidates whose endpoint rows earlier candidates of the same batch
    # append to: (1, 3) is two hops away once (1, 2) and (2, 3) land, but
    # a batch gates it against the rows as they stood at its start.
    "endpoint-appended-earlier": {"n": 64, "D": 4, "F": 16, "k": 2,
                                  "E": 64, "rows": {},
                                  "src": [1, 2, 1, 3, 2],
                                  "dst": [2, 3, 3, 4, 4],
                                  "paths": {"keep", "last-miss"}},
    # The same pair twice, and reversed, in one batch.
    "same-pair-twice": {"n": 64, "D": 4, "F": 16, "k": 2, "E": 64,
                        "rows": {},
                        "src": [4, 4, 5, 4, 6], "dst": [5, 5, 4, 6, 5],
                        "paths": {"keep", "last-miss"}},
    # The edge list holds 2: the sticky overflow.
    "list-overflow": {"n": 64, "D": 4, "F": 16, "k": 2, "E": 2,
                      "rows": {}, "src": [1, 3, 5, 7], "dst": [2, 4, 6, 8],
                      "paths": {"keep", "last-miss"}},
}


def case_state(case: dict) -> list:
    """The case's starting summary as numpy fields: ``nbr``, ``deg``,
    ``deg_overflow``, ``esrc``, ``edst``, ``n``, ``overflow``."""
    n, D, E = case["n"], case["D"], case["E"]
    nbr = np.full((n, D), -1, np.int32)
    deg = np.zeros(n, np.int32)
    for a, ids in case["rows"].items():
        nbr[a, :len(ids)] = ids
        deg[a] = len(ids)
    return [nbr, deg, np.array(0, np.int32), np.zeros(E, np.int32),
            np.zeros(E, np.int32), np.array(0, np.int32), np.array(False)]


def case_lanes(case: dict) -> tuple:
    """``(src, dst)`` as ``int32`` arrays."""
    return (np.array(case["src"], np.int32), np.array(case["dst"], np.int32))


def card_shape_state(n: int, D: int, E: int, seed: int) -> list:
    """A summary at a card's shape, vectorised: Zipf rows (hubs near id 0)
    filled to a random degree, so rounds hold duplicates across rows and
    some rows are full."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.geometric(0.15, n) - 1, D).astype(np.int32)
    ids = (rng.zipf(1.3, (n, D)) % n).astype(np.int32)
    nbr = np.where(np.arange(D)[None, :] < deg[:, None], ids,
                   -1).astype(np.int32)
    return [nbr, deg, np.array(0, np.int32), np.zeros(E, np.int32),
            np.zeros(E, np.int32), np.array(0, np.int32), np.array(False)]
