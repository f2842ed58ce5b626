"""Training: schedules, optimizer, freezing, grad-cache and the train step."""
