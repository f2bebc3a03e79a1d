"""Workload substrate: the Facebook trace parser, its synthetic stand-in,
the instance samplers and the arrival-process generators of the streaming
service (NumPy copies of `repro.traffic`)."""

from repro_torch.traffic.arrivals import (
    diurnal_arrivals,
    onoff_arrivals,
    periodic_waves,
    poisson_arrivals,
    with_releases,
)
from repro_torch.traffic.facebook import load_fbt, synthesize_facebook_like, to_demands
from repro_torch.traffic.instances import (
    paper_default_instance,
    random_instance,
    sample_instance,
    scaled_trace_instance,
)

__all__ = [
    "load_fbt",
    "synthesize_facebook_like",
    "to_demands",
    "sample_instance",
    "paper_default_instance",
    "scaled_trace_instance",
    "random_instance",
    "poisson_arrivals",
    "onoff_arrivals",
    "diurnal_arrivals",
    "periodic_waves",
    "with_releases",
]
