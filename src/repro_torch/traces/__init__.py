"""Seeded request and availability traces."""
