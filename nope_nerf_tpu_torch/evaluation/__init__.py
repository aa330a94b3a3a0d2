"""Evaluation of the port: test-time pose optimisation, full-image render
with PSNR/SSIM, depth errors and trajectory errors."""
