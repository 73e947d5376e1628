from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticClassification,
    SyntheticTokens,
    make_linear_regression,
    make_logistic_regression,
)
from repro_torch.data.partition import (  # noqa: F401
    dirichlet_partition,
    label_skew_partition,
    iid_partition,
)
from repro_torch.data.pipeline import NodeBatcher  # noqa: F401

__all__ = [
    "SyntheticClassification", "SyntheticTokens", "make_linear_regression",
    "make_logistic_regression", "dirichlet_partition", "label_skew_partition",
    "iid_partition", "NodeBatcher",
]
