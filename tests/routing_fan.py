"""A fan network for the routing kernel's tests: one origin, a hub with
``branches`` branches, each branch joined to both of two destinations.  At
the hub, each destination's softmax group from the origin's arm has one
entry per branch, more than the four a group's record carries, so the
kernel's streamed design sums those groups through its row accumulators;
both groups lie in one unit, so the unit has two to share between warps."""

import copy

import numpy as np

from pednstream_tpu_torch import NetworkEnvGenerator, build_scenario


def fan_scenario(device, branches=6, **kwargs):
    """The fan as a scenario on ``device`` (small_network's parameters,
    ``k_paths`` = ``branches``, every link at the default length)."""
    args = NetworkEnvGenerator(device=device).scenario_args("small_network")
    n = branches + 4
    hub, dests = 1, (n - 2, n - 1)
    edges = ([(0, hub)] + [(hub, k) for k in range(2, n - 2)]
             + [(k, d) for k in range(2, n - 2) for d in dests])
    adjacency = np.zeros((n, n), dtype=int)
    for a, b in edges:
        adjacency[a, b] = adjacency[b, a] = 1
    params = copy.deepcopy(args["params"])
    params["path_finder"]["k_paths"] = branches
    params["links"] = {}
    params["seed"] = 1
    return build_scenario(adjacency_matrix=adjacency.tolist(), params=params, origin_nodes=[0],
                          destination_nodes=list(dests), device=device, **kwargs)
