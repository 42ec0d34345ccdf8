"""Offline tools: body-model fitting and deformation transfer."""
