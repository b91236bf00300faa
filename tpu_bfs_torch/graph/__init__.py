"""Graph layer of the PyTorch port: CSR, loaders, generators, bucketed ELL."""
