"""Digital layers behind the FPCA frontend."""
