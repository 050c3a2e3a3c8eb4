"""Reporting: figures and demo strips (host only)."""
