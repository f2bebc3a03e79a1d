"""Workload substrate: the Facebook trace parser, its synthetic stand-in and
the paper's instance sampler (NumPy copies of `repro.traffic`)."""

from repro_torch.traffic.facebook import load_fbt, synthesize_facebook_like, to_demands
from repro_torch.traffic.instances import paper_default_instance, sample_instance

__all__ = [
    "load_fbt",
    "synthesize_facebook_like",
    "to_demands",
    "sample_instance",
    "paper_default_instance",
]
