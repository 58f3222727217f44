"""GatedGCN (arXiv:2003.00982): 16 layers, 70 hidden, gated aggregator
(PyTorch port of ``repro.configs.gnn_archs``).

Four shape cells share one model config; per-cell ``d_feat``/task vary
(full_graph_sm = Cora-like, minibatch_lg = Reddit-like + sampler,
ogb_products = full-batch-large, molecule = batched small graphs with a
categorical atom-type embedding).
"""

from __future__ import annotations

from repro_torch.configs.registry import ArchBundle, GNN_SHAPES, register
from repro_torch.models.gatedgcn import GatedGCNConfig


def make_config(variant: str = "full", shape: str = "full_graph_sm", **over):
    shapes_feat = {"full_graph_sm": 1433, "minibatch_lg": 602,
                   "ogb_products": 100, "molecule": 1}
    if variant == "smoke":
        kw = dict(name="gatedgcn-smoke", n_layers=3, d_hidden=16,
                  d_feat=over.pop("d_feat", 12), n_classes=4)
    else:
        kw = dict(name=f"gatedgcn-{shape}", n_layers=16, d_hidden=70,
                  d_feat=shapes_feat.get(shape, 100), n_classes=16)
    if shape == "molecule":
        kw.update(task="graph_class", atom_vocab=119, n_classes=2)
    kw.update(over)
    return GatedGCNConfig(**kw)


register(ArchBundle(
    arch_id="gatedgcn", kind="gnn", shapes=GNN_SHAPES,
    make_config=make_config,
    notes="ROBE inapplicable (dense float node features; no huge "
          "categorical table). molecule cells use a small atom-type "
          "embedding (vocab 119)."))
