"""The public models: SeekrPipeline, KmerCounter and pearson."""
