"""Device resolution, the kernel build, and state carried across from seekr_tpu."""
