"""The fast binomial sampler's least time (the function of
``engine._binom(mode="fast")``): per element the count, the sample and
one random input (the uniform where n <= 16, the normal above) move once,
and p's distinct values once; a walk of the pmf's recursion costs about
100 float operations an element, the Gaussian about 8."""

from portbench.peaks import least_seconds

OPS_SMALL, OPS_LARGE = 100, 8
SMALL_N = 16


def least_seconds_call(n: int, p_values: int, small: int) -> float:
    """One call over ``n`` elements, ``small`` of them with n <= 16, with
    ``p_values`` distinct probabilities."""
    moved = 4 * (3 * n + p_values)
    ops = OPS_SMALL * small + OPS_LARGE * (n - small)
    return least_seconds(moved, ops)


def least_seconds_step(batch: int, links: int, activity: bool) -> float:
    """The samples of one engine step on the fast path: the release
    (p per element), the activity stay (p per link) where any link has
    one, and the reverse occupancy (one p).  The bytes bound every call
    whatever the share of small counts, so every element is counted as
    the walk's."""
    n = batch * links
    calls = [n, 1] + ([links] if activity else [])
    return sum(least_seconds_call(n, p, n) for p in calls)
