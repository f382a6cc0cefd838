"""Analysis tools of the port (counterpart of
``gke_ray_train_tpu/analysis/``): ``kernelcheck``, the differential
verification of every registered kernel against its oracle and the
port's tolerance ledger.

    python -m gke_ray_train_tpu_torch.analysis kernelcheck [names...]
        [--record] [--device cuda|cpu] [--ledger-dir D] [--static-only]
"""
