"""Engine-backed training data of the port: a compressed columnar corpus
and SQL-style batch selection on it (the reference's ``repro.data``)."""
from repro_torch.data.corpus import (  # noqa: F401
    CorpusConfig, build_synthetic_corpus)
from repro_torch.data.pipeline import (  # noqa: F401
    DataPipeline, PipelineConfig, corpus_stats)
