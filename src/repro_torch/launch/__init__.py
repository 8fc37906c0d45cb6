"""Training entry points of the port: ``python -m repro_torch.launch.train``
(plain LM training) and ``python -m repro_torch.launch.federated_lm_silos``
(FedCGD over LM silos, one weighted train step a round)."""
