"""The synthetic, cursor-resumable data pipeline (a copy of
``repro.data``)."""

from repro_torch.data.synthetic import SyntheticPipeline, synthetic_batch  # noqa: F401
