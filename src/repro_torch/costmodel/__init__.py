"""Learned cost-model subsystem (ROADMAP item: learned cost model).

Turns the cross-kernel measurement memo into training data
(:mod:`repro_torch.costmodel.dataset`), fits a small MLP cycle predictor
(:mod:`repro_torch.costmodel.model`), and spends it through
ranker-guided search strategies (:mod:`repro_torch.costmodel.search` via
:mod:`repro_torch.costmodel.rankers`) that verify only their top-k
candidates on the real timer.  :mod:`repro_torch.costmodel.evaluator`
races every registered strategy under one measurement budget
(``python -m repro_torch.launch.evaluate``).

Port of ``repro/costmodel``; the MLP and the PPO agent behind
``PolicyRanker`` run on a torch device (the card unless asked for
another), the searches and their measurements on the host.
"""

from repro_torch.costmodel.dataset import (FEATURE_DIM, CostDataset,
                                           CostModelVersionError,
                                           ProgramFeaturizer)
from repro_torch.costmodel.evaluator import (DEFAULT_STRATEGIES,
                                             evaluate_strategies,
                                             format_table,
                                             heldout_rank_correlation,
                                             spearman)
from repro_torch.costmodel.model import CostModel
from repro_torch.costmodel.rankers import (CostModelRanker, CostRanker,
                                           OracleRanker, PolicyRanker,
                                           make_ranker)
from repro_torch.costmodel.search import (BeamSearchStrategy,
                                          GreedyLookaheadStrategy)

__all__ = [
    "CostDataset", "ProgramFeaturizer", "FEATURE_DIM",
    "CostModel", "CostModelVersionError",
    "CostRanker", "OracleRanker", "CostModelRanker", "PolicyRanker",
    "make_ranker",
    "BeamSearchStrategy", "GreedyLookaheadStrategy",
    "evaluate_strategies", "format_table", "heldout_rank_correlation",
    "spearman", "DEFAULT_STRATEGIES",
]
