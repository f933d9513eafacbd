"""Device ops of the port: vote, blur, contrast, warps and the CG minimizer."""
