"""k-mer count (plain version and CUDA launcher), normalize and Pearson ops."""
