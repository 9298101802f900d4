"""Launchers: the serve driver."""
