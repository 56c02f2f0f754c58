"""Training (mirrors ``ssp/train``): the LR schedule, the train state with
Adam over the network and the Kendall ηs, the step, checkpoints and the
agent behind ``python -m ssp_torch.cli.train``."""

from ssp_torch.train.lr import PolynomialDecayLR, polynomial_decay  # noqa: F401
from ssp_torch.train.state import TrainState  # noqa: F401
from ssp_torch.train.step import (accum_train_step, compute_losses, eval_step,  # noqa: F401
                                  train_step)
