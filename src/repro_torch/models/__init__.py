"""Models (PyTorch port of `repro.models`): the paper's models (`nn`,
`small`) and the large-architecture LM family (`attention`, `mamba2`,
`moe`, `transformer`)."""
