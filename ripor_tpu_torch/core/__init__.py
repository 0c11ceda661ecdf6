from ripor_tpu_torch.core.mesh import MeshSpec, create_mesh, local_mesh
from ripor_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY, Policy

__all__ = ["MeshSpec", "create_mesh", "local_mesh", "Policy",
           "DEFAULT_POLICY", "FP32_POLICY"]
