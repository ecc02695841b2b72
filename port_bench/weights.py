"""The weights of a run: one random net drawn for the configuration from a
fixed seed (reference/net.py `make_weights` from BASE_SEED, on the device),
then the run's seed permutes an inner width of every block. A random net's
search is a draw of its weights: with weights drawn from the run's seed,
two runs of one seed agreed within 10% and two seeds differed by up to 4
times (a self-play move of 4.7 s against 18 s), because the tree's depth
follows the draw's winrate. A permutation computes the same function, so
the seed changes the weights' order and the roots, and not the work. Both
sides get the result."""

from __future__ import annotations

import torch

from port_bench.reference import net as N

# the net every run starts from, before its seed's permutation
BASE_SEED = 20260418

# each family's inner widths the seed permutes: (the conv block whose
# outputs, the conv block whose inputs), under the block's name
INNER = {"residual": (("conv1", "conv2"),),
         "bottleneck": (("conv1", "conv2"),),
         "nested": (("block1.conv1", "block1.conv2"), ("block2.conv1", "block2.conv2")),
         "mixer": (("ffn1", "ffn2"),)}


@torch.no_grad()
def make(cfg, seed, device):
    """The base net, its blocks' inner channels permuted by the seed."""
    return permuted(cfg, N.make_weights(cfg, BASE_SEED, device), seed)


def permuted(cfg, w, seed):
    """`w` with the inner channels of each block (INNER: a conv's outputs,
    its batch norm, the next conv's inputs) permuted by draws of `seed`,
    one a width in block order: the same function in another order, so
    that the seed changes the weights and not the work."""
    g = torch.Generator().manual_seed(seed % (1 << 63))
    out = dict(w)
    for i, (kind, _, _) in enumerate(N.blocks(cfg)):
        for src, dst in INNER[kind]:
            src, dst = f"tower.{i}.{src}", f"tower.{i}.{dst}.conv.weight"
            weight = w[f"{src}.conv.weight"]
            perm = torch.randperm(weight.shape[0], generator=g).to(weight.device)
            for k in (f"{src}.conv.weight", f"{src}.bn.beta", f"{src}.bn.gamma",
                      f"{src}.bn.mean", f"{src}.bn.var"):
                if k in w:
                    out[k] = w[k][perm].contiguous()
            out[dst] = w[dst][:, perm].contiguous()
    return out
