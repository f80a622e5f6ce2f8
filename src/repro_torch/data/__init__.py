"""Input data (``data/`` of the reference): stateless-by-step token
sources and the prefetching pipeline."""
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_pipeline
from repro_torch.data.sources import MemmapTokens, SyntheticTokens, write_token_file

__all__ = ["DataConfig", "Prefetcher", "make_pipeline", "MemmapTokens",
           "SyntheticTokens", "write_token_file"]
