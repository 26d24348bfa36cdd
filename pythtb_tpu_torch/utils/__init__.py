"""Host-side helpers of pythtb_tpu_torch."""
