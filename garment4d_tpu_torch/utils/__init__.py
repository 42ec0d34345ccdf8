"""Configuration and command line."""
