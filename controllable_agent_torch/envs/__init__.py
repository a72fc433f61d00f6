"""Environments of the port: so far the kinematic side only (models, features,
observations and rewards as functions of stored physics); the dynamics and
rollouts are ROADMAP Queue A item 9."""
