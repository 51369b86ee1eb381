"""graph_trip_share: the vmapped planner's trips run from its CUDA graphs
(``utils/profiling.py::trip_graph.replays``) over every trip, the
rollout-kernel launches (the wrappers' ``.launches``: one a trip), both
counted from process start (set-up, window and slice): the share of the
trips whose torch glue the card replays, not the host launches op by op.
Nothing where the program has no such counter."""


def read(run):
    try:
        from cudasbmp_torch.utils.profiling import trip_graph
    except ImportError:
        return None
    from cudasbmp_torch.ops import rollout_cuda

    trips = sum(w.launches for w in rollout_cuda.WRAPPERS)
    return trip_graph.replays / trips if trips else None
