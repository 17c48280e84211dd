from instacart_next_order_recommendation_tpu_torch.baselines.run_baselines import main

main()
