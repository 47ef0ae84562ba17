"""repro_torch.data — D4M-backed ingest → tokenized batches."""
from .pipeline import CorpusPipeline, PipelineState, synth_corpus
from .tokenizer import ByteTokenizer

__all__ = ["CorpusPipeline", "PipelineState", "synth_corpus", "ByteTokenizer"]
