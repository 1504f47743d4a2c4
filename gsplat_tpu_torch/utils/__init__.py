"""Timing, card-peak and scan probes of the port."""
