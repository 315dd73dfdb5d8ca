"""Training: schedules, margin losses and the supervised SV train step."""
