"""The weights of a run: one random net drawn for the configuration from a
fixed seed (reference/net.py `make_weights` from BASE_SEED, on the device),
then the run's seed permutes every residual block's inner channels. A
random net's search is a draw of its weights: with weights drawn from the
run's seed, two runs of one seed agreed within 10% and two seeds differed
by up to 4 times (a self-play move of 4.7 s against 18 s), because the
tree's depth follows the draw's winrate. A permutation computes the same
function, so the seed changes the weights' order and the roots, and not
the work. Both sides get the result."""

from __future__ import annotations

import torch

from port_bench.reference import net as N

# the net every run starts from, before its seed's permutation
BASE_SEED = 20260418


@torch.no_grad()
def make(cfg, seed, device):
    """The base net, its blocks' inner channels permuted by the seed."""
    return permuted(cfg, N.make_weights(cfg, BASE_SEED, device), seed)


def permuted(cfg, w, seed):
    """`w` with each residual block's inner channels (conv1's outputs, its
    batch norm, conv2's inputs) permuted by a draw of `seed`: the same
    function in another order, so that the seed changes the weights and
    not the work."""
    g = torch.Generator().manual_seed(seed % (1 << 63))
    out = dict(w)
    for i in range(len(cfg["stack"])):
        pre = f"tower.{i}.conv1"
        perm = torch.randperm(cfg["residual_channels"], generator=g).to(w[f"{pre}.conv.weight"].device)
        for k in (f"{pre}.conv.weight", f"{pre}.bn.beta", f"{pre}.bn.mean", f"{pre}.bn.var"):
            out[k] = w[k][perm].contiguous()
        out[f"tower.{i}.conv2.conv.weight"] = w[f"tower.{i}.conv2.conv.weight"][:, perm].contiguous()
    return out
