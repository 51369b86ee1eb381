"""Tree and workspace plots (counterpart of cudasbmp_tpu/viz.py), the
Python stand-in for the reference's MATLAB scripts
(visualization/visualizationKGMT_Single.m and _Steps.m).

As the MATLAB ``_Single`` script does, an edge is drawn by re-integrating
its child's stored control from the parent state
(visualizationKGMT_Single.m:86-112), so a propagator fault shows as curves
that miss their nodes. The replay is the port's plain rollout on the host
(``ops/rollout.py::rollout_states``), every edge of a tree in one batch.
Reads a live KGMTResult, a ShardedTreeResult or a directory of the
reference-named artifact CSVs. matplotlib is imported when a plot is
drawn, never with this module; it is not a dependency of the package.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from cudasbmp_torch.config import SAMPLE_DIM, KGMTConfig
from cudasbmp_torch.ops.rollout import rollout_states
from cudasbmp_torch.systems.registry import get_system


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _integrate_edges(system, x0s: np.ndarray, controls: np.ndarray,
                     num_disc: int) -> np.ndarray:
    """Re-integrate E edges on the host: [E, num_disc + 1, state_dim]
    states from x0s [E, >= state_dim] and controls [E, control_dim + 1]
    (duration last)."""
    if len(x0s) == 0:
        return np.zeros((0, num_disc + 1, system.state_dim), np.float32)
    x0 = torch.as_tensor(np.asarray(x0s, np.float32)[:, :system.state_dim])
    ctrl = torch.as_tensor(np.asarray(controls, np.float32))
    return rollout_states(system, x0, ctrl, num_disc).numpy()


def _integrate_edge_states(system, x0: np.ndarray, control: np.ndarray,
                           num_disc: int) -> np.ndarray:
    """One edge's [num_disc + 1, state_dim] states."""
    return _integrate_edges(system, np.asarray(x0)[None], np.asarray(control)[None],
                            num_disc)[0]


def plot_tree(result=None, artifacts_dir: str | os.PathLike | None = None,
              config: KGMTConfig | None = None, out_path: str = "tree.png",
              obstacles: np.ndarray | None = None,
              max_edges: int | None = None,
              show_grid: bool = True,
              footprint: tuple[float, float] | None = None,
              _samples_path: os.PathLike | None = None,
              _parents_path: os.PathLike | None = None) -> str:
    """Render the search tree over the workspace; returns the written path.
    With ``footprint=(half_len, half_wid)`` (``config.footprint``) the
    body's oriented rectangle is drawn at every pose along the solution
    path."""
    plt = _pyplot()
    from matplotlib.collections import LineCollection

    cfg = config or KGMTConfig()
    system = get_system(cfg.system)
    if result is not None:
        samples = _host(result.state.tree_samples)
        parents = _host(result.state.tree_parent)
        tree_size = result.tree_size
        path_nodes = result.path_nodes
    else:
        if _samples_path is not None:
            sp, pp = Path(_samples_path), Path(_parents_path)
        else:
            d = Path(artifacts_dir)
            sp, pp = d / "samples.csv", d / "parentRelations.csv"
        samples = np.loadtxt(sp, delimiter=",").reshape(-1, SAMPLE_DIM)
        parents = np.loadtxt(pp, delimiter=",").astype(int)
        tree_size = int((parents >= 0).sum()) + 1
        path_nodes = None

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_xlim(0, cfg.width)
    ax.set_ylim(0, cfg.height)
    ax.set_aspect("equal")
    if show_grid:
        for i in range(cfg.N + 1):
            ax.axvline(i * cfg.r1_size, color="0.9", lw=0.5, zorder=0)
            ax.axhline(i * cfg.r1_size, color="0.9", lw=0.5, zorder=0)
    if obstacles is not None:
        for (x0, y0, x1, y1) in obstacles:
            ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                       color="0.3", zorder=2))
    # every edge replayed in one batch, drawn as one LineCollection; a
    # sharded tree's global parent ids past this shard's slots are dropped
    children = np.arange(1, tree_size)
    ok = (parents[1:tree_size] >= 0) & (parents[1:tree_size] < len(samples))
    children = children[ok]
    if max_edges is not None and len(children) > max_edges:
        children = children[:max_edges]
    if len(children) > 0:
        sts = _integrate_edges(system, samples[parents[children]],
                               samples[children, 4:7], cfg.num_disc)
        ax.add_collection(LineCollection(sts[:, :, :2], colors="tab:blue",
                                         linewidths=0.3, alpha=0.4, zorder=1))
    ax.scatter(samples[:tree_size, 0], samples[:tree_size, 1], s=1,
               color="tab:blue", zorder=3)
    if path_nodes is not None and len(path_nodes) > 1:
        for i in range(1, len(path_nodes)):
            p, c = path_nodes[i - 1], path_nodes[i]
            sts = _integrate_edge_states(system, samples[p], samples[c, 4:7],
                                         cfg.num_disc)
            ax.plot(sts[:, 0], sts[:, 1], color="tab:red", lw=2.0, zorder=4)
            if footprint is not None:
                from cudasbmp_torch.geometry.footprint import footprint_corners

                hi = getattr(system, "heading_index", None)
                theta = sts[:, hi] if hi is not None else np.zeros(len(sts), np.float32)
                corners = footprint_corners(torch.as_tensor(sts[:, 0]),
                                            torch.as_tensor(sts[:, 1]),
                                            torch.as_tensor(theta), footprint[0],
                                            footprint[1]).numpy()
                for quad in corners:
                    ax.add_patch(plt.Polygon(quad, closed=True, fill=False,
                                             edgecolor="tab:orange", lw=0.5,
                                             zorder=4))
    ax.set_title(f"KGMT tree ({tree_size} nodes)")
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_steps(record_dir: str | os.PathLike, config: KGMTConfig | None = None,
               obstacles: np.ndarray | None = None,
               out_dir: str | os.PathLike = "frames",
               every: int = 1, max_edges: int | None = None) -> list[str]:
    """Per-iteration tree-growth frames from a ``plan_recorded`` dump (the
    visualizationKGMT_Steps.m workflow over Samples/samples<i>.csv and
    Parents/parents<i>.csv). Returns the written frame paths."""
    rec = Path(record_dir)
    outd = Path(out_dir)
    outd.mkdir(parents=True, exist_ok=True)
    sample_files = sorted((rec / "Samples").glob("samples*.csv"),
                          key=lambda p: int(p.stem[len("samples"):]))
    frames = []
    for f in sample_files[::every]:
        it = int(f.stem[len("samples"):])
        frames.append(plot_tree(
            config=config, obstacles=obstacles,
            out_path=str(outd / f"tree_{it:04d}.png"), max_edges=max_edges,
            _samples_path=f, _parents_path=rec / "Parents" / f"parents{it}.csv"))
    return frames


def plot_metrics(metrics: dict, out_path: str = "metrics.png") -> str:
    """Per-iteration counters: frontier size, valid/accepted, tree growth."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    it = np.arange(len(metrics["frontier_size"]))
    axes[0].plot(it, metrics["frontier_size"])
    axes[0].set_title("frontier size")
    axes[1].plot(it, metrics["valid"], label="valid")
    axes[1].plot(it, metrics["accepted"], label="accepted")
    axes[1].legend()
    axes[1].set_title("rollouts per iteration")
    axes[2].plot(it, metrics["tree_size"])
    axes[2].set_title("tree size")
    for ax in axes:
        ax.set_xlabel("iteration")
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_sharded_path(result, config: KGMTConfig | None = None,
                      obstacles: np.ndarray | None = None,
                      out_path: str = "sharded_path.png") -> str:
    """Render a ShardedTreeResult's stitched path, each edge coloured by the
    shard owning its child node: the picture of one logical tree whose
    paths cross shards. Edges are replayed from the stored controls, so an
    edge that misses its node would show a stitching fault."""
    plt = _pyplot()
    cfg = config or KGMTConfig()
    system = get_system(cfg.system)
    path = np.asarray(result.path if hasattr(result, "path") else result)
    shards = np.asarray(result.path_shards)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_xlim(0, cfg.width)
    ax.set_ylim(0, cfg.height)
    ax.set_aspect("equal")
    if obstacles is not None:
        for (x0, y0, x1, y1) in obstacles:
            ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                       color="0.3", zorder=2))
    cmap = plt.get_cmap("tab10")
    seen = set()
    sts = _integrate_edges(system, path[:-1], path[1:, 4:7], cfg.num_disc)
    for i in range(1, len(path)):
        d = int(shards[i])
        label = f"shard {d}" if d not in seen else None
        seen.add(d)
        ax.plot(sts[i - 1, :, 0], sts[i - 1, :, 1], color=cmap(d % 10), lw=2.0,
                zorder=4, label=label)
    ax.scatter(path[:, 0], path[:, 1], s=14,
               c=[cmap(int(d) % 10) for d in shards], zorder=5)
    n_cross = int((shards[1:] != shards[:-1]).sum())
    ax.set_title(f"sharded-tree path: {len(path)} nodes, "
                 f"{len(seen)} shards, {n_cross} boundary crossings")
    if seen:
        ax.legend(loc="upper right", fontsize=8)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path
