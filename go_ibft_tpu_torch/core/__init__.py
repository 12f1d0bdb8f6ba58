"""The pieces of ``go_ibft_tpu.core`` the port's verifier needs."""
