from .pipeline import Prefetcher, SyntheticLMData

__all__ = ["SyntheticLMData", "Prefetcher"]
