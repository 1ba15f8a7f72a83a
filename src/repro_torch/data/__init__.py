from repro_torch.data.pipeline import SyntheticTokens, make_batch

__all__ = ["SyntheticTokens", "make_batch"]
