from .pipeline import Prefetcher, SyntheticLMData, TextLMData, make_corpus

__all__ = ["SyntheticLMData", "TextLMData", "Prefetcher", "make_corpus"]
