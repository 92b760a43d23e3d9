"""Host utilities: matrix generation / verification and timing."""

from ft_sgemm_tpu_torch.utils.matrices import generate_random_matrix, verify_matrix

__all__ = ["generate_random_matrix", "verify_matrix"]
