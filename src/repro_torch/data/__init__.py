from repro_torch.data.pipeline import PrefetchIterator, SyntheticLM

__all__ = ["PrefetchIterator", "SyntheticLM"]
