"""Training objectives (reference pytorch/losses.py).

``clip_bce`` is the loss of the reference training loop (main.py:950),
computed from logits with the numerically stable formula
max(x, 0) - x * z + log1p(exp(-|x|)), equal to BCE on sigmoid
probabilities. The F1 and set-accuracy objectives are ported too.
"""

from __future__ import annotations

import torch


def clip_bce(output_dict: dict, target_dict: dict) -> torch.Tensor:
    """Mean binary cross-entropy (losses.py:8-10), from logits."""
    x = output_dict["clipwise_logits"].float()
    z = target_dict["target"].float()
    return (torch.relu(x) - x * z + torch.log1p(torch.exp(-torch.abs(x)))).mean()


def f1_loss_objective(binarized_output: torch.Tensor, y_true: torch.Tensor,
                      average: str = "micro") -> torch.Tensor:
    """Negative (micro) F1 (losses.py:20-40)."""
    eps = 1e-12
    if average == "micro":
        y_true = y_true.reshape(-1)
        binarized_output = binarized_output.reshape(-1)
    tp = torch.sum(y_true * binarized_output, dim=0)
    pred_p = torch.sum(binarized_output, dim=0)
    pos = torch.sum(y_true, dim=0)
    precision = tp / (pred_p + eps)
    recall = tp / (pos + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    return -f1.mean()


def macro_f1_loss_objective(binarized_output: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return f1_loss_objective(binarized_output, y_true, average="macro")


def set_acc_loss_objective(binarized_output: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Negative micro true-positive count (losses.py:80-94)."""
    tp = torch.sum(y_true.reshape(-1) * binarized_output.reshape(-1), dim=0)
    return -tp.mean()


def _objective_as_loss(objective):
    """An (output, target) objective as a loss(output_dict, target_dict),
    on the clipwise probabilities."""

    def loss(output_dict: dict, target_dict: dict) -> torch.Tensor:
        return objective(output_dict["clipwise_output"], target_dict["target"].float())

    return loss


def get_loss_func(loss_type: str):
    if loss_type == "clip_bce":
        return clip_bce
    if loss_type == "f1micro":
        return _objective_as_loss(f1_loss_objective)
    if loss_type == "f1macro":
        return _objective_as_loss(macro_f1_loss_objective)
    if loss_type == "set_acc":
        return _objective_as_loss(set_acc_loss_objective)
    raise ValueError(f"unknown loss type {loss_type!r}")
