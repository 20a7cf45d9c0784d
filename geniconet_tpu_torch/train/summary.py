"""Model summaries: the parameter count, the parameter table and the graph drawing.

Port of ``geniconet_tpu/train/summary.py`` (the torchsummary surface the
reference saves at train start, run.py:427-430). The JAX package builds
both texts from the flax parameter tree; here they come from the same tree
under the same names (``bridge``'s flax layout, as ``Trainer.variables()``
or ``bridge.init_variables`` give it), its dict keys flattened in sorted
order as ``jax.tree`` flattens them, so each text equals JAX's byte for byte.
"""

from __future__ import annotations

import io
import math
import re

from geniconet_tpu_torch.bridge import flatten_tree

__all__ = ["count_params", "model_summary", "model_graph_dot"]


def count_params(params) -> int:
    """Elements in a tree (nested dicts) of arrays or tensors, such as the
    ``"params"`` tree of ``Trainer.variables()``."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return math.prod(params.shape)


def _leaves(tree):
    """(path of keys, shape, element count) of every leaf, in jax.tree's order."""
    return [(path, tuple(leaf.shape), math.prod(leaf.shape)) for path, leaf in flatten_tree(tree)]


def model_summary(variables: dict) -> str:
    """Table of the parameters by module path (shape, count), their total,
    and the BatchNorm statistics' count, from a flax-layout variable tree."""
    rows = [("/".join(path), shape, n) for path, shape, n in _leaves(variables["params"])]
    out = io.StringIO()
    total = sum(r[2] for r in rows)
    w = max(len(r[0]) for r in rows) + 2
    out.write(f"{'module/param':{w}} {'shape':24} {'count':>12}\n")
    out.write("-" * (w + 38) + "\n")
    for name, shape, n in rows:
        out.write(f"{name:{w}} {str(shape):24} {n:>12,}\n")
    out.write("-" * (w + 38) + "\n")
    out.write(f"{'total':{w}} {'':24} {total:>12,}\n")
    bstats = variables.get("batch_stats", {})
    if bstats:
        nb = count_params(bstats)
        out.write(f"{'batch_stats (non-trainable)':{w}} {'':24} {nb:>12,}\n")
    return out.getvalue()


def model_graph_dot(variables: dict, model_name: str, input_shape) -> str:
    """Graphviz DOT drawing of the module hierarchy (the torchsummary
    ``draw_graph`` surface, reference run.py:427-430): a root node
    ``model_name`` with the input shape, one node per module, containment
    edges parent->child, dashed sequential edges between numbered sibling
    stages (down0->down1, up0->up1, ...), leaf modules annotated with their
    parameter shapes and counts. Render with ``dot -Tpng``."""
    modules: dict = {}  # module path -> {param name: (shape, count)}
    for path, shape, n in _leaves(variables["params"]):
        mod, pname = path[:-1] or ("(root)",), path[-1]
        modules.setdefault(mod, {})[pname] = (shape, n)
        for d in range(1, len(mod)):
            modules.setdefault(mod[:d], {})

    def nid(mod):
        return "n_" + "_".join(mod).replace("(", "").replace(")", "")

    out = io.StringIO()
    out.write("digraph model {\n  rankdir=TB;\n  node [shape=box, fontsize=10];\n")
    out.write(f'  root [label="{model_name}\\ninput {tuple(input_shape)}"];\n')
    for mod in sorted(modules):
        lines = [mod[-1]] + [f"{k} {list(s)} ({n:,})" for k, (s, n) in sorted(modules[mod].items())]
        out.write(f'  {nid(mod)} [label="' + "\\n".join(lines) + '"];\n')
    for mod in sorted(modules):
        parent = "root" if len(mod) == 1 else nid(mod[:-1])
        out.write(f"  {parent} -> {nid(mod)};\n")
    # sequential flow between numbered sibling stages (down0 -> down1, ...)
    by_parent: dict = {}
    for mod in modules:
        by_parent.setdefault(mod[:-1], []).append(mod)
    for sibs in by_parent.values():
        staged = sorted([m for m in sibs if re.search(r"\d+$", m[-1])],
                        key=lambda m: (re.sub(r"\d+$", "", m[-1]),
                                       int(re.search(r"\d+$", m[-1]).group())))
        for a, b in zip(staged, staged[1:]):
            if re.sub(r"\d+$", "", a[-1]) == re.sub(r"\d+$", "", b[-1]):
                out.write(f"  {nid(a)} -> {nid(b)} [style=dashed, color=gray];\n")
    out.write("}\n")
    return out.getvalue()
