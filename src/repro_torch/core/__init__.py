"""Ferret's planner, schedule, compensation, pipeline engine and trainer."""
