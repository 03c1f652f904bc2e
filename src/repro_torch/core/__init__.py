"""Coflow model, scheduler parameters and the coordinator tick."""
