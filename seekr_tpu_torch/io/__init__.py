"""FASTA reading, sequence encoding and streamed Pearson blocks."""
