"""Optimizer construction. Port of gaitpd/train/optim.py:16-23.

torch.optim.SGD(lr, momentum=0.9, weight_decay=1e-4) is what the reference
trains with (train/weargait_train.py:560); gaitpd decomposes it into
the equivalent optax chain (grad += wd * p, buf = mu * buf + grad,
p -= lr * buf), whose first momentum buffer is the gradient itself, as
torch's. ``adamw_torch`` and ``adam_torch`` wait for the baselines
(ROADMAP Queue 1, item 13).
"""

from __future__ import annotations

from typing import Iterable

import torch


def sgd_torch(params: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.9,
              weight_decay: float = 1e-4) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay,
                           nesterov=False)
