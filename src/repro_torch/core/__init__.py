"""FedLuck core (PyTorch port of `repro.core`).

  compression  — C_δ operators (top-k et al.) + error feedback (Sec 2.2)
  factor       — key convergence factor φ(k, δ) and Eq. 15 solvers (Sec 3.2)
  controller   — α/β profiling + per-device (k_i, δ_i) planning (Alg. 1)
  aggregation  — periodic/buffered/async/sync servers (Sec 2.2, baselines)
  simulator    — event-driven AFL engine with simulated clock (Sec 4.3)
"""
