"""Training loss: the reference's 11-term objective (port of
sayuri_tpu.train.loss), weights, temperatures, deltas and detach points
as there:

  1.0   CE(prob, target policy)
  0.15  CE(aux prob, opponent target policy)
  0.1   CE(soft prob, target^(1/4) renormalized)         [soft_weight]
  0.015 CE(soft aux, aux target^(1/4) renormalized)      [0.15 * soft_weight]
  1.0   CE(optimistic prob, target) weighted by realized surprise
  1.5   masked MSE(ownership)
  1.0   CE(wdl)
  1.0   MSE(q_vals[5])
  0.0012 Huber(scores[5], delta=12)
  2.0   square-Huber(short-term q error head, delta=0.4)
  2e-5  square-Huber(short-term score error head, delta=100)
"""

from __future__ import annotations

import torch


def cross_entropy(pred_logits, target, weight=None):
    ls = -torch.sum(torch.log_softmax(pred_logits, -1) * target, -1)
    if weight is not None:
        ls = ls * weight
    return torch.mean(ls)


def huber(x, y, delta, weight=None):
    ad = torch.abs(x - y)
    l = torch.where(ad > delta, 0.5 * delta * delta + delta * (ad - delta), 0.5 * ad * ad)
    ls = torch.sum(l, -1)
    if weight is not None:
        ls = ls * weight
    return torch.mean(ls)


def make_soft_prob(prob, policy_mask, eps=1e-7, t=4.0):
    sp = torch.pow((prob + eps) * policy_mask, 1.0 / t)
    return sp / torch.sum(sp, -1, keepdim=True)


def _square_huber(pred, x, y, delta, eps, weight):
    """Huber of the error head against the squared error of the (detached)
    short-term prediction: the gradient reaches the error head only."""
    sqerr = torch.square(x - y) + eps
    return huber(pred[:, None], sqerr[:, None], delta, weight)


def compute_loss(outputs, targets, mask, soft_weight=0.1):
    """`outputs`: SayuriNet head dict. `targets`: dict with prob/aux_prob
    [B, HW+1], ownership [B, HW], wdl [B, 3], q_vals [B, 5], scores [B, 5]
    and, optionally, global_weight [B]. `mask`: [B, H, W, 1] board mask.
    Returns (loss, dict of the loss and its ten named parts)."""
    b = mask.shape[0]
    mask_flat = mask.reshape(b, -1)
    mask_sum_hw = torch.sum(mask_flat, -1)
    policy_mask = torch.cat([mask_flat, mask_flat.new_ones(b, 1)], -1)
    gw = targets.get("global_weight")

    t_prob = targets["prob"]
    t_aux = targets["aux_prob"]

    prob_loss = cross_entropy(outputs["prob"], t_prob, gw)
    aux_loss = 0.15 * cross_entropy(outputs["aux_prob"], t_aux, gw)
    soft_loss = soft_weight * cross_entropy(
        outputs["soft_prob"], make_soft_prob(t_prob, policy_mask), gw)
    soft_aux_loss = 0.15 * soft_weight * cross_entropy(
        outputs["soft_aux_prob"], make_soft_prob(t_aux, policy_mask), gw)

    # optimistic policy: weight by realized short-term surprise
    st_q_pred = outputs["q_vals"][:, 2].detach()
    st_q_tgt = targets["q_vals"][:, 2]
    st_s_pred = outputs["scores"][:, 2].detach()
    st_s_tgt = targets["scores"][:, 2]
    q_err = outputs["errors"][:, 0].detach()
    s_err = outputs["errors"][:, 1].detach()
    z_q = (st_q_tgt - st_q_pred) / torch.sqrt(q_err + 1e-4)
    z_s = (st_s_tgt - st_s_pred) / torch.sqrt(s_err + 0.25)
    opt_w = torch.clamp(
        torch.sigmoid((z_q - 1.5) * 3.0) + torch.sigmoid((z_s - 1.5) * 3.0), 0.0, 1.0)
    optimistic_loss = cross_entropy(outputs["optimistic_prob"], t_prob, opt_w)

    gw_or_1 = gw if gw is not None else 1.0
    ownership_loss = 1.5 * torch.mean(
        torch.sum(torch.square(outputs["ownership"] - targets["ownership"]), -1)
        / mask_sum_hw * gw_or_1)
    wdl_loss = cross_entropy(outputs["wdl"], targets["wdl"])
    q_vals_loss = torch.mean(
        torch.mean(torch.square(outputs["q_vals"] - targets["q_vals"]), -1) * gw_or_1)
    scores_loss = 0.0012 * huber(outputs["scores"], targets["scores"], 12.0, gw)

    q_error_loss = 2.0 * _square_huber(
        outputs["errors"][:, 0], st_q_pred, st_q_tgt, 0.4, 1e-8, gw)
    score_error_loss = 2e-5 * _square_huber(
        outputs["errors"][:, 1], st_s_pred, st_s_tgt, 100.0, 1e-4, gw)
    errors_loss = q_error_loss + score_error_loss

    loss = (prob_loss + aux_loss + soft_loss + soft_aux_loss + optimistic_loss
            + ownership_loss + wdl_loss + q_vals_loss + scores_loss + errors_loss)
    return loss, {
        "loss": loss,
        "prob_loss": prob_loss,
        "aux_prob_loss": aux_loss,
        "soft_prob_loss": soft_loss,
        "soft_aux_prob_loss": soft_aux_loss,
        "optimistic_loss": optimistic_loss,
        "ownership_loss": ownership_loss,
        "wdl_loss": wdl_loss,
        "q_vals_loss": q_vals_loss,
        "scores_loss": scores_loss,
        "errors_loss": errors_loss,
    }
