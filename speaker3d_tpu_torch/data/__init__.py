"""Host data pipeline of the trainer: wav crops, speed perturbation,
augmentation, batches, and their copy to the card."""
