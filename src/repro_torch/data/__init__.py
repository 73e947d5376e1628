from repro_torch.data.synthetic import SyntheticTokens, make_linear_regression

__all__ = ["SyntheticTokens", "make_linear_regression"]
