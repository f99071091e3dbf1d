"""Offline tools: the standalone generator-CLI analog."""
