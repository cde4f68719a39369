from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_data

__all__ = ["DataConfig", "SyntheticLM", "make_data"]
