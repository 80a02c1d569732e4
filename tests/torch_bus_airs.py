"""The bus test AIRs of `tests/test_interaction.py` (a range lookup of
queries into a table with multiplicities; a permutation check of sends
against receives), built over either package's BaseAir and buses, and
the traces of its cases. This module imports no JAX, so the card tests
can use it with the port's classes."""

import numpy as np


def bus_airs(base, lookup_bus, permutation_bus):
    """{name: AIR class} over `base`, speaking on lookup_bus("range8")
    and permutation_bus("pipe")."""
    rng_bus = lookup_bus("range8")
    pipe = permutation_bus("pipe")

    class QueryAir(base):
        """Every row looks one value up on the range bus."""

        width = 1
        num_public_values = 0

        def __init__(self, field):
            self.field = field

        def eval(self, b):
            rng_bus.lookup_key(b, [b.main.local[0]], 1)

    class TableAir(base):
        """The 0..n-1 range table with per-entry multiplicities."""

        width = 2  # value, multiplicity
        num_public_values = 0

        def __init__(self, field):
            self.field = field

        def eval(self, b):
            local, nxt = b.main.local, b.main.next
            b.when_first_row().assert_zero(local[0])
            b.when_transition().assert_eq(nxt[0], local[0] + 1)
            rng_bus.table_entry(b, [local[0]], local[1])

    class SendAir(base):
        """Sends (a, b) pairs on the pipe bus."""

        width = 2
        num_public_values = 0

        def __init__(self, field):
            self.field = field

        def eval(self, b):
            pipe.send(b, [b.main.local[0], b.main.local[1]], 1)

    class RecvAir(base):
        """Receives (a, b) pairs on the pipe bus."""

        width = 2
        num_public_values = 0

        def __init__(self, field):
            self.field = field

        def eval(self, b):
            pipe.receive(b, [b.main.local[0], b.main.local[1]], 1)

    return dict(QueryAir=QueryAir, TableAir=TableAir, SendAir=SendAir,
                RecvAir=RecvAir)


def lookup_traces(seed, log_q, log_t=None, unbalanced=False):
    """Standard-form uint32 traces: 2^log_q queries drawn below 2^log_t
    (default log_q) and the 2^log_t-row table with their multiplicities;
    `unbalanced` raises one multiplicity by one."""
    log_t = log_q if log_t is None else log_t
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 1 << log_t, size=1 << log_q)
    counts = np.bincount(q, minlength=1 << log_t)
    if unbalanced:
        counts[0] += 1
    return (q.reshape(-1, 1).astype(np.uint32),
            np.stack([np.arange(1 << log_t), counts], axis=1)
            .astype(np.uint32))


def permutation_traces(seed, log_n, P, unbalanced=False):
    """Standard-form uint32 (sent, received) pair traces, the received a
    permutation of the sent; `unbalanced` changes one received value."""
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    pairs = rng.integers(0, P, size=(n, 2)).astype(np.uint32)
    other = pairs[rng.permutation(n)]
    if unbalanced:
        other[0, 0] = (int(other[0, 0]) + 1) % P
    return pairs, other
