from .pipeline import DataConfig, SyntheticLMDataset, make_batch_iterator, synthetic_batch
