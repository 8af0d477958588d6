"""HEANA core as PyTorch modules (counterpart of ``repro.core``)."""
from repro_torch.core.types import (Backend, Dataflow, OpticalParams,
                                    PhotonicConfig, resolve_device)
from repro_torch.core.hw import (EventEnergies, OperatingPoint, TraceEnergy,
                                 check_kernel_plan_coherence,
                                 kernel_plan_mismatches, trace_energy)
from repro_torch.core.photonic_gemm import (detection_sigma,
                                            device_level_dot, fold_seed,
                                            noise_shape, num_chunks,
                                            photonic_dot_general,
                                            sample_noise)
from repro_torch.core.scalability import (max_dpe_size, output_power_dbm,
                                          fig9_surface, table2_dpu_config)
from repro_torch.core.taom import (quantize, taom_multiply,
                                   encode_time_amplitude)
from repro_torch.core import bpca, noise

__all__ = [
    "Backend", "Dataflow", "OpticalParams", "PhotonicConfig",
    "resolve_device", "photonic_dot_general", "device_level_dot",
    "detection_sigma", "fold_seed", "sample_noise",
    "noise_shape", "num_chunks",
    "OperatingPoint", "EventEnergies", "TraceEnergy", "trace_energy",
    "kernel_plan_mismatches", "check_kernel_plan_coherence",
    "max_dpe_size", "output_power_dbm", "fig9_surface", "table2_dpu_config",
    "quantize", "taom_multiply", "encode_time_amplitude", "bpca", "noise",
]
