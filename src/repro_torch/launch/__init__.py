"""Serving entry points of the port (`lm_serve`) and the steps they run
(`steps`)."""
